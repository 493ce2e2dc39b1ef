"""Automatic operator-format selection from a scipy sparse matrix.

Reference equivalent: R1 (SURVEY.md §3.1) — Eigen's sparse-times-dense takes
ANY sparsity and the library user never chooses a format. Here the fast path
depends on structure, so ``from_scipy_auto`` inspects the matrix (host-side,
cheap integer scans) and picks the container predicted fastest:

  1. few distinct diagonals        -> DIAOperator (shifted diagonal sums)
  2. tile-densifiable under RCM    -> TiledOperator(reorder="rcm")
                                      (dense tiles; bf16 tiles optional
                                      via tile_dtype)
  3. bounded row width             -> ELLOperator (XLA fixed-width gather)
  4. otherwise                     -> CSROperator (XLA segment-sum)

The RCM choice applies in a permuted row order; every operator exposes
``to_solver_order`` / ``from_solver_order`` (identity by default,
operators/base.py) so caller code is format-agnostic:

    op = from_scipy_auto(a)
    X, info = solve_sbcgrq(op, op.to_solver_order(B))
    X = op.from_solver_order(X)

The tiled-vs-gather decision uses rate models measured with
bench_scattered.py (n = 32768, k = 32, f32) on an NVIDIA H100 80GB HBM3
at a 700 W power limit:

  tiled(RCM) nnz/s ~= 16.7 Gnnz/s x tile fill   (least-squares line
      through the delaunay/RGG/expander sweep: fills 0.072% -> 3.24%
      measured 0.012 -> 0.52 Gnnz/s, each within 9% of the line)
  ELL nnz/s        ~= 12.8 Gnnz/s x (mean_deg / max_deg)^2   (12.8 is the
      measured ELL rate on the exact-regular expander, the random-row
      gather with no padding; padded meshes measured 5.9-21.5 Gnnz/s)

Tiling wins when its predicted rate clears the ELL prediction by a 1.3x
margin AND the fill clears the hard floor ``min_fill`` (default 35% =
break-even against the WORST measured gather rate, 5.9 Gnnz/s). On that
card the hardware gather wins for every measured matrix by 10-1000x, so
the tile route is chosen only for matrices that are nearly block-dense.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _predicted_rcm_fill(a, T: int = 128):
    """(fill, ntiles, perm) of P A P^T under RCM, without building tiles.
    The perm is returned so the selected TiledOperator reuses it — the RCM
    pass and the permuted-CSR materialization are the dominant host cost on
    large meshes and must not run twice."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    ap = a[perm][:, perm].tocsr()
    n = ap.shape[0]
    ct = np.asarray(ap.indices, dtype=np.int64) // T
    rt = np.repeat(np.arange(n, dtype=np.int64) // T, np.diff(ap.indptr))
    ntiles = np.unique(rt * (-(-n // T)) + ct).size
    return ap.nnz / (ntiles * T * T), ntiles, perm


# Rate-model constants measured on an NVIDIA H100 80GB HBM3 (700 W),
# k=32, with bench_scattered.py (see the module docstring).
_TILED_GNNZS_PER_FILL = 16.7   # tiled nnz/s = this x tile fill
_GATHER_BOUND_GNNZS = 12.8     # random-row gather, no padding
_TILED_MARGIN = 1.3            # tile only when predicted to win by this


def from_scipy_auto(
    a,
    dtype=jnp.float32,
    *,
    max_diagonals: int = 48,
    min_fill: float = 0.35,
    max_ell_width: int = 64,
    max_pad_bytes: int = 8 << 30,
    tile_dtype=None,
    verbose: bool = False,
):
    """Pick and build the best operator container for ``a`` (square sparse).

    Args:
      max_diagonals: use DIA when the matrix has at most this many distinct
        nonzero diagonals (stencils/banded matrices; the DIA apply
        streams one coefficient row per diagonal).
      min_fill: hard fill floor for the RCM tile format (default = the
        measured break-even against the worst gather rate; the measured
        rate model above it decides tiled-vs-gather per matrix).
      max_ell_width: fall back to ELL when the max row degree is bounded by
        this, else CSR.
      tile_dtype: forwarded to TiledOperator (e.g. jnp.bfloat16).
    """
    from blockcg.operators.csr import CSROperator, ELLOperator
    from blockcg.operators.dia import DIAOperator
    from blockcg.operators.tiled import TiledOperator

    a = a.tocsr()
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"square matrix required, got {a.shape}")
    coo = a.tocoo()
    offsets = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))

    if offsets.size <= max_diagonals:
        if verbose:
            print(f"[auto] DIA: {offsets.size} diagonals")
        return DIAOperator.from_scipy(a, dtype=dtype)

    counts = np.diff(a.indptr)
    fill, ntiles, perm = _predicted_rcm_fill(a)
    tiled_est = _TILED_GNNZS_PER_FILL * fill
    ell_ok = counts.max() <= max_ell_width
    gather_est = _GATHER_BOUND_GNNZS * (
        (counts.mean() / max(counts.max(), 1)) ** 2 if ell_ok else 0.25)
    if (fill >= min_fill and tiled_est >= _TILED_MARGIN * gather_est
            and ntiles * 128 * 128 * 4 <= max_pad_bytes):
        if verbose:
            print(f"[auto] tiled+RCM: predicted fill {fill:.2%}, "
                  f"{ntiles} tiles, est {tiled_est:.2f} vs gather "
                  f"{gather_est:.2f} Gnnz/s")
        try:
            return TiledOperator.from_scipy(
                a, dtype=dtype, perm=perm, tile_dtype=tile_dtype,
                max_pad_bytes=max_pad_bytes,
            )
        except ValueError:
            # Padding after the tile-multiple row pad crossed the budget
            # (the estimate above is pre-padding): fall through to the
            # gather formats — falling back IS the selector's job.
            pass

    if ell_ok:
        if verbose:
            print(f"[auto] ELL: width {int(counts.max())} (tiled est "
                  f"{tiled_est:.2f} did not clear gather est "
                  f"{gather_est:.2f} Gnnz/s x {_TILED_MARGIN})")
        return ELLOperator.from_scipy(a, dtype=dtype)
    if verbose:
        print(f"[auto] CSR: max row degree {int(counts.max())}")
    return CSROperator.from_scipy(a, dtype=dtype)
