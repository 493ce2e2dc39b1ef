"""Sparse-tile operator — the general-sparsity container (arbitrary CSR/BSR).

Built from any scipy matrix via the native C++ tilizer (blockcg/native.py)
with numpy fallback; applies as a tile gather, one batched dense tile
product and a segment sum over row tiles.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class TiledOperator(MatmatMixin):
    tiles: jax.Array   # (ntiles, T, T) f32 dense tiles
    rt: jax.Array      # (ntiles,) int32 row-tile index, sorted
    ct: jax.Array      # (ntiles,) int32 col-tile index
    first: jax.Array   # (ntiles,) int32 first-in-row-tile flag
    n: int
    # RCM metadata travels IN the pytree (perm as an int32 leaf, the rest
    # static) so jit/tree_map round-trips cannot silently drop the row
    # ordering and turn from_solver_order into the identity.
    perm: jax.Array | None = None   # (n0,) reordering, or None
    n0: int | None = None           # original (pre-padding) row count
    nnz_logical: int | None = None

    @property
    def T(self) -> int:
        return self.tiles.shape[1]

    @property
    def ntiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        # logical nnz if recorded at construction; padded size otherwise
        if self.nnz_logical is not None:
            return self.nnz_logical
        return self.ntiles * self.T * self.T

    @property
    def fill(self) -> float:
        """Tile density: logical nnz / padded tile footprint — THE efficiency
        knob of the tile format (throughput ~= fill x tile-load bandwidth).
        Reported so benchmarks can chart the density -> throughput curve
        honestly."""
        return self.nnz / (self.ntiles * self.T * self.T)

    @property
    def dtype(self):
        # Solver-facing dtype: bf16 tile STORAGE still computes/accumulates
        # in f32 (upcast at apply), so fields stay f32.
        t = self.tiles.dtype
        return jnp.float32 if t == jnp.bfloat16 else t

    def to_solver_order(self, B):
        """Map an (n0, k) RHS in the ORIGINAL row order to the internal
        (reordered + identity-padded) order the operator applies in.
        Identity when the operator was built without ``reorder``."""
        perm = self.perm
        n0 = self.n if self.n0 is None else self.n0
        B = jnp.asarray(B)
        if perm is not None:
            B = B[perm]
        if n0 != self.n:
            pad = [(0, self.n - n0)] + [(0, 0)] * (B.ndim - 1)
            B = jnp.pad(B, pad)
        return B

    def from_solver_order(self, X):
        """Inverse of :meth:`to_solver_order`: drop padding rows and undo
        the bandwidth-reducing permutation."""
        n0 = self.n if self.n0 is None else self.n0
        X = X[:n0]
        if self.perm is not None:
            # Derived cache (safe to lose on pytree round-trips): the
            # argsort costs a device->host fetch of perm + O(n log n) host
            # work per call otherwise.
            iperm = getattr(self, "_iperm", None)
            if iperm is None:
                iperm = jnp.asarray(np.argsort(np.asarray(self.perm)))
                object.__setattr__(self, "_iperm", iperm)
            X = X[iperm]
        return X

    def reordered_scipy(self, a):
        """Apply this operator's row ordering (RCM permutation + identity
        padding) to a scipy matrix: the companion matrix in INTERNAL order,
        e.g. for building the f64 outer operator of solve_refined
        (CSROperator.from_scipy(op.reordered_scipy(a), dtype=f64))."""
        import scipy.sparse as sp

        a = a.tocsr()
        if self.perm is not None:
            p = np.asarray(self.perm)
            a = a[p][:, p].tocsr()
        if a.shape[0] != self.n:
            a = sp.block_diag(
                [a, sp.eye(self.n - a.shape[0])], format="csr")
        return a

    @classmethod
    def from_scipy(
        cls, a, dtype=jnp.float32, force_numpy: bool = False,
        max_pad_bytes: int = 8 << 30, reorder: str | None = None,
        tile_dtype=None, perm=None,
    ):
        """Build the sparse-tile operator.

        Args:
          reorder: ``"rcm"`` applies reverse Cuthill-McKee bandwidth
            reduction (host-side, scipy.sparse.csgraph) BEFORE tiling —
            scattered-but-local sparsity (meshes, geometric graphs)
            densifies by 10-20x, which is the whole game for the tile
            format (SURVEY.md §8 hard part 2). The operator then applies in
            the permuted order; convert fields with ``to_solver_order`` /
            ``from_solver_order`` (solves are permutation-equivariant, so
            only the API-boundary vectors move).
          tile_dtype: storage dtype for the tile values (default: ``dtype``).
            ``jnp.bfloat16`` halves the padded-tile memory traffic while
            the apply still upcasts to f32 and accumulates in f32 (matrix
            entries are rounded to bf16;
            compose with solve_refined + an f64 ``op64`` for full accuracy,
            exactly like the f32-matrix refinement story).
        """
        from blockcg.native import tilize_csr

        a = a.tocsr()
        n0 = n = a.shape[0]
        if perm is None and reorder is not None:
            if reorder != "rcm":
                raise ValueError(f"unknown reorder {reorder!r} (use 'rcm')")
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = reverse_cuthill_mckee(a, symmetric_mode=True)
        if perm is not None:  # precomputed (from_scipy_auto) or RCM above
            perm = np.asarray(perm, dtype=np.int64)
            a = a[perm][:, perm].tocsr()
        T = 128
        if n % T:  # pad to a tile multiple with identity on the diagonal
            import scipy.sparse as sp

            npad = T - n % T
            a = sp.block_diag([a, sp.eye(npad)], format="csr")
            n = a.shape[0]
        # The tile format targets block-dense sparsity: estimate the padded
        # footprint first — truly scattered matrices (one nnz per 128x128
        # tile) would blow up memory by ~16000x. Use CSR/ELL (XLA gather
        # path) for those.
        col_t = np.asarray(a.indices).astype(np.int64) // T
        indptr = np.asarray(a.indptr)
        rtile = np.repeat(np.arange(n, dtype=np.int64) // T, np.diff(indptr))
        ntiles_est = int(np.unique(rtile * (n // T) + col_t).size)
        pad_bytes = ntiles_est * T * T * 4
        if pad_bytes > max_pad_bytes:
            raise ValueError(
                f"matrix too scattered for the {T}x{T} tile format: "
                f"{ntiles_est} tiles = {pad_bytes/2**30:.1f} GiB padded "
                f"(fill {a.nnz/(ntiles_est*T*T):.2%}); use CSROperator/"
                f"ELLOperator instead"
            )
        tiles, rt, ct, first = tilize_csr(
            a, T, force_numpy=force_numpy, dtype=np.dtype(jnp.dtype(dtype).name)
        )
        store = jnp.dtype(dtype if tile_dtype is None else tile_dtype)
        return cls(
            tiles=jnp.asarray(tiles, dtype=store),
            rt=jnp.asarray(rt),
            ct=jnp.asarray(ct),
            first=jnp.asarray(first),
            n=int(n),
            perm=None if perm is None else jnp.asarray(perm, jnp.int32),
            n0=int(n0),
            nnz_logical=int(a.nnz),
        )

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        k, n = Xt.shape
        T = self.T
        Xb = Xt.reshape(k, n // T, T)
        xg = Xb[:, self.ct, :]  # (k, ntiles, T)
        tiles = self.tiles
        if tiles.dtype != Xt.dtype:  # bf16 storage: upcast, f32 math
            tiles = tiles.astype(Xt.dtype)
        contrib = jax.lax.dot_general(
            xg, tiles,
            (((2,), (2,)), ((1,), (0,))),  # contract T, batch over tiles
            preferred_element_type=Xt.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # (ntiles, k, T)
        Yb = jax.ops.segment_sum(
            contrib, self.rt, num_segments=n // T, indices_are_sorted=True
        )  # (n//T, k, T)
        return jnp.transpose(Yb, (1, 0, 2)).reshape(k, n)


jax.tree_util.register_dataclass(
    TiledOperator,
    data_fields=["tiles", "rt", "ct", "first", "perm"],
    meta_fields=["n", "n0", "nnz_logical"],
)
