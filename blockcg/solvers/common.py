"""Shared solver primitives (L3), distribution-aware via ``axis_name``.

Layout: the hot internal convention is **lanes-major** — an (n, k) block V is
carried as ``Vt = V^T`` of shape (k, n), so the large row dimension is the
contiguous minor axis (see operators/base.py). All helpers here speak
(k, n); public (n, k) wrappers are provided for the API/tests.

Distribution: every reduction over the row dimension n takes an optional
``axis_name``. With ``axis_name=None`` the solver runs single-device. Under
``shard_map`` over a row-sharded mesh axis, the *same solver code* runs on
the local row shard and these helpers insert ``lax.psum`` — this is the
entire distributed story for everything except the SpMM halo (SURVEY.md
§3.4, §4.3: "the n-sized data never moves").

k x k algebra (Cholesky, triangular solves) is replicated on every device —
k <= 64, negligible (SURVEY.md R3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def psum_if(x, axis_name: str | None):
    return x if axis_name is None else lax.psum(x, axis_name)


def acc_dtype(dt):
    """Accumulation dtype for a field dtype: bf16 fields accumulate in f32
    (bf16 in, f32 out, as matrix units take them); everything else keeps its
    own dtype. k x k solver algebra (Grams, alpha/rho/S) always lives in
    the accumulation dtype — only the large (k, n) fields are stored bf16."""
    return jnp.float32 if dt == jnp.bfloat16 else dt


# Field-algebra codec shims (operators/base.py): a codec is any operator
# exposing coeff_expand / gram_contract / norms2_contract. ``codec=None``
# means flat fields (identity). Contractions run BEFORE psum (k x k rides
# the wire, not m x m); expansions are k x k -> m x m kroneckers (tiny).


def _ce(codec, C):
    return C if codec is None else codec.coeff_expand(C)


def _gc(codec, G):
    return G if codec is None else codec.gram_contract(G)


def _nc(codec, v):
    return v if codec is None else codec.norms2_contract(v)


def mm(a, b):
    """Small k x k times field matmul at full f32 precision (HIGHEST: no
    TF32 or bf16 passes on any backend).

    ``b`` is any lanes-major field ``(k, ...)`` — flat (k, n) or the block
    operators' native (k, bs, ns) view (kept 3D end-to-end: reshaping the
    lane dim at an XLA boundary is a physical relayout copy of the block)."""
    return jnp.tensordot(
        a, b, axes=(1, 0), precision=HIGHEST, preferred_element_type=a.dtype
    )


def _field_dims(Ut: jax.Array) -> tuple[int, ...]:
    return tuple(range(1, Ut.ndim))


# Rows per partial Gram, for fields longer than GRAM_CHUNKED_ABOVE rows.
# One f32 dot over millions of rows accumulates rounding error with the row
# count and with the algorithm the BLAS picks: at 16.7M rows, k=64 the
# Gram's error reached 2e-5 of its diagonal (NVIDIA H100, f32) and SBCGrQ's
# iteration count moved by 20% between one card and four. Partial Grams
# over fixed-length row chunks, summed by a reduction, bound the error by
# the chunk length and make it independent of n and of how the rows are
# sharded. Shorter fields keep the single dot: the batched form has too
# little parallelism there (2x slower per iteration at 262k rows, H100).
GRAM_CHUNK = 1 << 14
GRAM_CHUNKED_ABOVE = 1 << 20


def gram_t(Ut: jax.Array, Vt: jax.Array, axis_name: str | None = None,
           codec=None) -> jax.Array:
    """Gram block ``U^H V`` (k x k) from lanes-major fields (k, ...).

    Conjugate-correct: for complex Hermitian systems this is the sesquilinear
    Gram; ``jnp.conj`` is a no-op on real dtypes."""
    adt = acc_dtype(Ut.dtype)  # bf16 fields: widen, then accumulate in f32
    U, V = jnp.conj(Ut).astype(adt), Vt.astype(adt)
    n = U.shape[-1]
    if n > GRAM_CHUNKED_ABOVE and n % GRAM_CHUNK == 0:
        c = n // GRAM_CHUNK
        U = U.reshape(U.shape[:-1] + (c, GRAM_CHUNK))
        V = V.reshape(V.shape[:-1] + (c, GRAM_CHUNK))
        b = U.ndim - 2  # the chunk axis, batched; the rest contracted
        dims = tuple(range(1, b)) + (b + 1,)
        G = lax.dot_general(
            U, V, ((dims, dims), ((b,), (b,))), precision=HIGHEST,
            preferred_element_type=adt,
        ).sum(axis=0)
    else:
        dims = _field_dims(Ut)
        G = lax.dot_general(
            U, V, ((dims, dims), ((), ())), precision=HIGHEST,
            preferred_element_type=adt,
        )
    return psum_if(_gc(codec, G), axis_name)


def vdot_real(u, v, axis_name: str | None = None):
    """Conjugating inner product, real part — exact for the CG-family
    quantities r^H r and p^H A p, which are real for Hermitian A.
    bf16 fields reduce in f32 (the bf16-tier accumulation rule; a bf16
    jnp.vdot both loses the norm and leaks bf16 scalars into while_loop
    carries)."""
    adt = acc_dtype(u.dtype)
    return psum_if(jnp.real(jnp.vdot(u.astype(adt), v.astype(adt))),
                   axis_name)


def row_norms2_t(Ut: jax.Array, axis_name: str | None = None,
                 codec=None) -> jax.Array:
    """Squared column norms of U (real), from a field (k, ...) -> (k,)."""
    U = Ut.astype(acc_dtype(Ut.dtype))  # bf16 squares/sums lose the norm
    s = jnp.sum(jnp.real(U * jnp.conj(U)), axis=_field_dims(Ut))
    return psum_if(_nc(codec, s), axis_name)


def safe_cholesky(G: jax.Array) -> jax.Array:
    """Cholesky of a k x k SPD Gram with a NaN-triggered jitter fallback.

    Near-converged RHS columns make the Gram nearly singular (SURVEY.md §8
    hard part 4). Both factorizations are computed (k x k — cheap) and the
    jittered one is selected only where the plain one produced NaN.
    """
    L = jnp.linalg.cholesky(G)
    k = G.shape[0]
    eps = jnp.finfo(G.dtype).eps
    jitter = (jnp.real(jnp.trace(G)) / k) * eps * 32.0 + jnp.finfo(
        jnp.real(G).dtype
    ).tiny
    L2 = jnp.linalg.cholesky(G + jitter * jnp.eye(k, dtype=G.dtype))
    bad = jnp.any(jnp.isnan(L))
    return jnp.where(bad, L2, L)


def chol_solve_spd(M: jax.Array, B: jax.Array) -> jax.Array:
    """Solve ``M X = B`` for SPD k x k ``M`` via Cholesky."""
    L = safe_cholesky(M)
    Y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(L.conj().T, Y, lower=False)


def chol_inverse_spd(M: jax.Array) -> jax.Array:
    """Explicit inverse of SPD k x k ``M`` (k <= 64: negligible; keeping the
    inverse explicit makes the big (k,k)@(k,n) updates plain matmuls)."""
    return chol_solve_spd(M, jnp.eye(M.shape[0], dtype=M.dtype))


def tri_inverse_upper(R: jax.Array) -> jax.Array:
    """Explicit inverse of upper-triangular k x k ``R``."""
    return jax.scipy.linalg.solve_triangular(
        R, jnp.eye(R.shape[0], dtype=R.dtype), lower=False
    )


def _cholqr_once_t(Vt: jax.Array, axis_name: str | None):
    """One CholeskyQR pass with column equilibration, lanes-major.

    Math: V = Q R (R upper triangular). Lanes-major: Vt = R^T Qt, returns
    (Qt, R). R includes the un-equilibration (triangular x diagonal).
    """
    nrm2 = row_norms2_t(Vt, axis_name)
    d = lax.rsqrt(jnp.maximum(nrm2, jnp.finfo(nrm2.dtype).tiny)).astype(
        acc_dtype(jnp.real(Vt).dtype)
    )
    Vs = (Vt.astype(d.dtype) if jnp.isrealobj(Vt) else Vt) * d.reshape(
        d.shape + (1,) * (Vt.ndim - 1))
    G = gram_t(Vs, Vs, axis_name)
    L = safe_cholesky(G)  # G = L L^H, so R_s = L^H
    Rinv_s = tri_inverse_upper(L.conj().T)
    # Q = Vs R_s^{-1}  ->  Qt = R_s^{-T} Vs_t = Rinv_s^T @ Vs
    Qt = mm(Rinv_s.T, Vs).astype(Vt.dtype)
    R = L.conj().T / d[None, :]  # R_s @ diag(1/d): un-equilibrate the columns
    return Qt, R


def cholqr_t(Vt: jax.Array, passes: int = 2, axis_name: str | None = None):
    """Thin QR via CholeskyQR (T-C3, reference R4 equivalent), lanes-major.

    CholeskyQR2 when ``passes=2`` (recommended in f32): the second pass
    restores orthogonality lost to the squared condition number of the first
    Gram. Distribution: the only cross-device ops are the k x k psums inside
    ``gram_t`` / ``row_norms2_t``.
    """
    Qt, R = _cholqr_once_t(Vt, axis_name)
    for _ in range(passes - 1):
        Qt, R2 = _cholqr_once_t(Qt, axis_name)
        R = mm(R2, R)
    return Qt, R


# ------------------------------------------------- block-update helpers ----
#
# The per-iteration field updates of the block solvers, each a short chain
# of k x k-times-field products and adds that XLA fuses into few passes.
# ``codec`` expands k x k coefficients to the operator's internal rows;
# ``axis_name`` psums ride on the tiny k x k results.


f_gram = gram_t


def f_mm_update(M, Bt, At=None, codec=None):
    """M @ B (+ A) (M expanded to internal rows via codec)."""
    M = _ce(codec, M)
    Y = mm(M, Bt)
    Y = Y if At is None else Y + At
    return Y.astype(Bt.dtype)  # bf16 fields: compute f32, store bf16


def f_mm_update_gram(M, Bt, At=None, axis_name: str | None = None,
                     codec=None):
    """(Y = M @ B (+ A), G = Y Y^H) (codec-aware)."""
    Y = f_mm_update(M, Bt, At, codec)
    return Y, gram_t(Y, Y, axis_name, codec)


def f_mm2_update_gram(M1, B1t, M2, B2t, axis_name: str | None = None,
                      codec=None):
    """(Y = M1 @ B1 + M2 @ B2, G = Y Y^H) (codec-aware).

    The implicit-Q residual-direction update: V = Q - Z alpha with
    Q = M_qr @ W never materialized."""
    M1, M2 = _ce(codec, M1), _ce(codec, M2)
    Y = (mm(M1, B1t) + mm(M2, B2t)).astype(B1t.dtype)
    return Y, gram_t(Y, Y, axis_name, codec)


def f_xr_update_gram(alpha, Pt, Xt, Zt, Rt, axis_name: str | None = None,
                     codec=None):
    """(Xn = X + alpha @ P, Rn = R - alpha @ Z, S' = Rn Rn^H) (codec-aware)
    — the BCG/BCGA solution and residual updates."""
    A = _ce(codec, alpha)
    Xn = (Xt + mm(A, Pt)).astype(Xt.dtype)
    Rn = (Rt - mm(A, Zt)).astype(Rt.dtype)
    return Xn, Rn, gram_t(Rn, Rn, axis_name, codec)


def f_px_update(M1, Wt, rho, Pt, C, Xt, codec=None):
    """(Pn = M1 @ W + rho @ P, Xn = X + C @ P) — the implicit-Q SBCGrQ
    iteration tail (no Q write)."""
    M1, rho, C = _ce(codec, M1), _ce(codec, rho), _ce(codec, C)
    Pn = (mm(M1, Wt) + mm(rho, Pt)).astype(Pt.dtype)
    return Pn, (Xt + mm(C, Pt)).astype(Xt.dtype)


def f_qr_p_update(M2, Q1t, rho, Pt, codec=None):
    """(Q = M2 @ Q1, Pn = Q + rho @ P) (codec-aware)."""
    M2, rho = _ce(codec, M2), _ce(codec, rho)
    Qt = mm(M2, Q1t)
    return Qt.astype(Q1t.dtype), (Qt + mm(rho, Pt)).astype(Pt.dtype)


def f_qr_px_update(M2, Q1t, rho, Pt, C, Xt, codec=None):
    """(Q = M2 @ Q1, Pn = Q + rho @ P, Xn = X + C @ P) — the SBCGrQ
    iteration tail with an explicit Q."""
    M2, rho, C = _ce(codec, M2), _ce(codec, rho), _ce(codec, C)
    Qt = mm(M2, Q1t)
    return (Qt.astype(Q1t.dtype), (Qt + mm(rho, Pt)).astype(Pt.dtype),
            (Xt + mm(C, Pt)).astype(Xt.dtype))


def f_matmat_gram(op, Xt, axis_name: str | None = None):
    """(Z = A X, M = X^H Z), the Gram contracted by the operator and psummed
    across shards (operators/base.py ``matmat_gram_t``)."""
    Zt, Mloc = op.matmat_gram_t(Xt)
    return Zt, psum_if(Mloc, axis_name)


def kk_mm(a, b):
    """Tiny k x k @ k x k product at full precision."""
    return jnp.matmul(a, b, precision=HIGHEST, preferred_element_type=a.dtype)


def qr_factors_from_gram(G, want_cond: bool = False):
    """One equilibrated CholeskyQR pass from a precomputed Gram ``G = V V^T``
    (lanes-major): returns (M1, R1) with ``Q = M1 @ V`` and ``V = Q R1``.

    The equilibration norms are ``diag(G)`` — no separate norm pass. Same
    math as ``_cholqr_once_t`` (which recomputes the Gram from V).

    ``want_cond`` additionally returns the 1-norm condition estimate
    ``kappa_1(G1) = ||G1||_1 ||G1^{-1}||_1`` of the EQUILIBRATED Gram — the
    quantity that bounds one-pass CholeskyQR's orthogonality loss
    (~eps * kappa_1). All k x k work: G1^{-1} = Rinv Rinv^H from the factor
    already in hand."""
    dg = jnp.real(jnp.diagonal(G))
    d = lax.rsqrt(jnp.maximum(dg, jnp.finfo(dg.dtype).tiny))
    G1 = G * d[:, None] * d[None, :]
    L = safe_cholesky(G1)
    Rinv_s = tri_inverse_upper(L.conj().T)
    M1 = Rinv_s.T * d[None, :]
    R1 = L.conj().T / d[None, :]
    if want_cond:
        G1inv = kk_mm(Rinv_s, Rinv_s.conj().T)
        cond1 = (jnp.max(jnp.sum(jnp.abs(G1), axis=0))
                 * jnp.max(jnp.sum(jnp.abs(G1inv), axis=0)))
        return M1, R1, cond1
    return M1, R1


def qr_gram_refine(M1, R1, G):
    """k x k-only second CholeskyQR pass, computed FROM THE GRAM (zero field
    passes): ``H = M1 G M1^H`` is Q1^H Q1 as implied by G; factoring H and
    folding it into the transform repairs the FACTORIZATION error of an
    ill-conditioned or jitter-repaired first pass — the mechanism that makes
    one-pass CholeskyQR of a (near-)rank-deficient block blow up. It cannot
    see the field-level rounding of the Gram accumulation itself; the
    kappa-triggered residual replacement (solvers/sbcgrq.py) covers that."""
    # Lanes-major transform: Q1 = V M1^T (column world), so
    # Q1^H Q1 = conj(M1) G M1^T — NOT M1 G M1^H (differs for complex G).
    H = kk_mm(jnp.conj(M1), kk_mm(G, M1.T))
    H = 0.5 * (H + H.conj().T)
    M2, R2 = qr_factors_from_gram(H)
    return kk_mm(M2, M1), kk_mm(R2, R1)


def qr_ortho_err(M, G):
    """k x k-side orthogonality estimate of the transform M against the
    Gram G of the field it will be applied to: ``H = conj(M) G M^T`` is
    Q^H Q as implied by G, and ``max|H - I|`` tracks the TRUE field-level
    ``||Q^H Q - I||_max`` to the digit (measured: 0.976 vs 0.974 on a
    numerically rank-deficient block; 2.4e-7 on a healthy one). Costs only
    k x k work — the breakdown detector for blocks CholeskyQR cannot
    repair (kappa^2(V) >> 1/eps: near-duplicate RHS columns)."""
    H = kk_mm(jnp.conj(M), kk_mm(G, M.T))
    k = H.shape[0]
    return jnp.max(jnp.abs(H - jnp.eye(k, dtype=H.dtype)))


def qr_passes_from_gram(G, Wt, passes: int, axis_name: str | None = None,
                        codec=None, want_cond: bool = False,
                        want_ortho: bool = False):
    """Run CholeskyQR passes given a precomputed Gram, DEFERRING the final
    orthonormalization so the caller can fuse it (with the P update in
    SBCGrQ, or a plain f_mm_update). Returns (M_last, W_last, rho): apply
    ``mm(M_last, W_last)``-style to finish; ``rho`` is the accumulated R
    factor (V = Q rho). Shared by the SBCGrQ/BCGdQ/shifted-block bodies.
    ``want_cond`` appends the first pass's kappa_1(G1) estimate.

    ``passes=1`` is ADAPTIVE, the SBCGrQ default: the k x k Gram-side
    refinement (``qr_gram_refine``, zero field passes) always runs, and a
    REAL second field pass is taken under ``lax.cond`` only when
    kappa_1(G1) exceeds ``0.5 / sqrt(eps)`` — beyond that the Gram-side
    triple product cancels below working precision (the kappa^2 limit of
    CholeskyQR) and only a recomputed field Gram can repair the basis
    (exact rank deficiency: duplicate/zero RHS columns). The predicate is
    replicated across devices (G is post-psum), so under shard_map every
    device takes the same branch."""
    if passes == 1:
        Mi, Ri, cond1 = qr_factors_from_gram(G, want_cond=True)
        rdtype = jnp.real(jnp.empty((), G.dtype)).dtype
        kappa_crit = 0.5 / jnp.sqrt(jnp.finfo(rdtype).eps)

        def two_pass(args):
            Mi, Ri, Wt = args
            Wt2, G2 = f_mm_update_gram(Mi, Wt, None, axis_name, codec)
            Mi2, Ri2 = qr_factors_from_gram(G2)
            oe = qr_ortho_err(Mi2, G2) if want_ortho else None
            return (Mi2, Wt2, kk_mm(Ri2, Ri)) + ((oe,) if want_ortho else ())

        def refine_only(args):
            Mi, Ri, Wt = args
            Mi, Ri = qr_gram_refine(Mi, Ri, G)
            oe = qr_ortho_err(Mi, G) if want_ortho else None
            return (Mi, Wt, Ri) + ((oe,) if want_ortho else ())

        out = lax.cond(
            cond1 > kappa_crit, two_pass, refine_only, (Mi, Ri, Wt)
        )
        Mi, Wt, rho = out[:3]
        extras = ()
        if want_cond:
            extras += (cond1,)
        if want_ortho:
            extras += (out[3],)
        return (Mi, Wt, rho) + extras if extras else (Mi, Wt, rho)

    rho = None
    Mi = None
    cond1 = None
    for p in range(passes):
        if p == 0 and want_cond:
            Mi, Ri, cond1 = qr_factors_from_gram(G, want_cond=True)
        else:
            Mi, Ri = qr_factors_from_gram(G)
        rho = Ri if rho is None else kk_mm(Ri, rho)
        if p < passes - 1:
            Wt, G = f_mm_update_gram(Mi, Wt, None, axis_name, codec)
    extras = ()
    if want_cond:
        extras += (cond1,)
    if want_ortho:
        extras += (qr_ortho_err(Mi, G),)
    return (Mi, Wt, rho) + extras if extras else (Mi, Wt, rho)


def residual_rebase(S, Sn):
    """Unitary change of basis between a drifted and a freshly recomputed
    residual factorization: ``R = Qn Sn = (Qn U^H)(U Sn)`` with
    ``U = Q^H Qn = S Sn^{-1}`` (both Q's orthonormal, same span => U
    unitary). Re-expressing the fresh pair in the OLD basis keeps the
    solver's ``P^T Q = I`` invariant intact through a residual replacement —
    replacing (Q, S) by the raw fresh pair rotates the basis under P and
    diverges (measured: config-3 replace_every=10 blew up to relres ~1e3).

    All k x k: one triangular solve. Regularized so exactly-zero residual
    columns (converged RHS, deflation padding) map through the identity."""
    rdt = jnp.real(jnp.empty((), S.dtype)).dtype
    d = (jnp.finfo(rdt).eps * jnp.max(jnp.abs(jnp.diagonal(Sn)))
         + jnp.finfo(rdt).tiny).astype(S.dtype)
    E = d * jnp.eye(S.shape[0], dtype=S.dtype)
    # U (Sn + dI) = (S + dI); Sn upper triangular with positive diagonal.
    Ut = jax.scipy.linalg.solve_triangular(
        (Sn + E).T, (S + E).T, lower=True
    )
    return Ut.T


def cholqr_fused_t(Vt, passes: int = 2, axis_name: str | None = None,
                   Gv=None, codec=None):
    """Thin QR via CholeskyQR(2) built on the block-update helpers.

    Optionally takes a precomputed ``Gv = V V^T`` (e.g. from the
    residual-direction update), saving the initial Gram pass entirely.
    Returns (Qt, R): V = Q R. Used by the hot SBCGrQ loop; the standalone
    ``cholqr_t`` remains for generic callers."""
    if passes < 1:
        raise ValueError("passes must be >= 1")
    G = f_gram(Vt, Vt, axis_name, codec) if Gv is None else Gv
    Mi, Wt, rho = qr_passes_from_gram(G, Vt, passes, axis_name, codec)
    return f_mm_update(Mi, Wt, codec=codec), rho


# ------------------------------------------------------ (n, k) wrappers ----


def block_dot(U, V, axis_name: str | None = None):
    return gram_t(U.T, V.T, axis_name)


def col_norms2(U, axis_name: str | None = None):
    return row_norms2_t(U.T, axis_name)


def cholqr(V, passes: int = 2, axis_name: str | None = None):
    """Thin QR of an (n, k) block: V = Q R. Public wrapper over cholqr_t."""
    Qt, R = cholqr_t(V.T, passes=passes, axis_name=axis_name)
    return Qt.T, R
