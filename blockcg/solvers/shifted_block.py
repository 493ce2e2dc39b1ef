"""Multi-shift block CG — shifted SBCGrQ (T-S4, block flavor).

Solves ``(A + sigma_j I) X_j = B`` for many shifts sigma_j >= 0 and an
(n, k) RHS block with ONE block-Krylov space: one SpMM per iteration total
(reference R8 equivalent, SURVEY.md §1.1; the block generalization of
Jegerlehner's shifted CG, built on the Lanczos view instead of residual
collinearity because k x k coefficients do not commute).

Derivation. SBCGrQ's orthonormal residual blocks Q_0, Q_1, ... are a block
Lanczos basis of the block Krylov space of (A, B): from the recurrences
(solvers/sbcgrq.py, lanes-major docstring)

    A Q_i = -Q_{i-1} M_{i-1} rho_i^H + Q_i (M_i + rho_i M_{i-1} rho_i^H)
            - Q_{i+1} rho_{i+1} M_i

with M_i = P_i^H A P_i (the seed Gram; alpha_i = M_i^{-1}) and rho_i the
CholQR factors. So A [Q_0..Q_I] = [Q_0..Q_{I+1}] T with Hermitian block
tridiagonal

    T_ii      = M_i + rho_i M_{i-1} rho_i^H          (rho_0 = 0)
    T_{i+1,i} = -rho_{i+1} M_i .

Since the block Krylov space is shift invariant and every shift starts from
the same B = Q_0 S_0, the Galerkin solution for shift sigma is
X_sigma = [Q_0..Q_I] y with (T + sigma I) y = E_1 S_0. Incremental block
LDL^H of (T + sigma):

    Delta_0 = T_00 + sigma
    Lambda_{i-1} = T_{i,i-1} Delta_{i-1}^{-1}
    Delta_i = T_ii + sigma - Lambda_{i-1} Delta_{i-1} Lambda_{i-1}^H

with forward-substituted coefficient and search blocks

    z_0 = S_0,   z_i = -Lambda_{i-1} z_{i-1}                (k x k)
    C_0 = Q_0,   C_i = Q_i - C_{i-1} Lambda_{i-1}^H         (n x k)
    X_sigma += C_i (Delta_i^{-1} z_i)

and the shifted true-residual coefficient R_sigma = -Q_{i+1} T_{i+1,i} y_i
= Q_{i+1} rho_{i+1} M_i Delta_i^{-1} z_i, whose column norms are the per-RHS
shifted residual norms (Q orthonormal) — convergence monitoring costs k x k.

Per shift the extra state is two (n, k) fields (C, X) updated by batched
matmuls, and a handful of k x k blocks — the survey's "shift axis is a
leading-dimension change" (SURVEY.md §1.2).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from blockcg.types import SolverInfo
from blockcg.solvers.common import (
    HIGHEST,
    chol_inverse_spd,
    cholqr_fused_t,
    f_matmat_gram,
    f_mm_update_gram,
    f_qr_p_update,
    kk_mm,
    qr_passes_from_gram,
    row_norms2_t,
)


def _smm(a, b):
    """Batched (nshift, k, k) @ (nshift, k, ...) over the shift axis."""
    return jnp.einsum(
        "sij,sj...->si...", a, b, precision=HIGHEST,
        preferred_element_type=a.dtype,
    )


def _smm_f(op, a, b):
    """Batched coefficient-times-FIELD product: expands each (k, k) in the
    (nshift, k, k) stack to the operator's internal row dim (codec) first."""
    return _smm(jax.vmap(op.coeff_expand)(a), b)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "qr_passes", "axis_name",
                              "record_history")
)
def _shifted_sbcgrq_impl(op, Bt, sigmas, tol, max_iter, qr_passes, axis_name,
                         record_history=False):
    dtype = Bt.dtype
    rdtype = jnp.real(Bt).dtype
    ns = sigmas.shape[0]

    bnorm = jnp.sqrt(row_norms2_t(Bt, axis_name, codec=op))
    bnorm = jnp.where(bnorm > 0, bnorm, jnp.asarray(1.0, rdtype))
    tol_arr = jnp.asarray(tol, rdtype)

    Q0t, S0 = cholqr_fused_t(Bt, passes=qr_passes, axis_name=axis_name,
                             codec=op)
    # k = number of RHS — taken from the CONTRACTED QR factor, not from the
    # field's leading dim (merged layouts carry m = bs*k internal rows).
    k = S0.shape[0]
    eye = jnp.eye(k, dtype=dtype)

    def relres_of(coef):
        # coef: (nshift, k, k) = rho_{i+1} M_i Delta_i^{-1} z_i
        nrm = jnp.sqrt(jnp.sum(jnp.real(coef * jnp.conj(coef)), axis=1))
        return nrm / bnorm[None, :]

    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    def cond(state):
        rel, it = state[8], state[9]
        return jnp.logical_and(it < max_iter, jnp.any(rel > tol_arr))

    def body(state):
        (Xs, Cs, Qt, Pt, rho_prev, M_prev, Dinv_prev, z_prev, rel, it,
         hist) = state
        Zt, M = f_matmat_gram(op, Pt, axis_name)  # P^H A P = alpha^{-1}
        alpha = chol_inverse_spd(M)

        # ---- per-shift incremental block LDL^H step (all k x k) ----------
        # T_ii = M + rho_i M_{i-1} rho_i^H ; T_{i,i-1} = -rho_i M_{i-1}
        rmp = kk_mm(rho_prev, M_prev)                       # rho_i M_{i-1}
        D = M + kk_mm(rmp, rho_prev.conj().T)
        Lam = -_smm(jnp.broadcast_to(rmp, (ns, k, k)), Dinv_prev)
        Delta = (
            D[None]
            + sigmas[:, None, None].astype(dtype) * eye[None]
            + _smm(Lam, jnp.broadcast_to(rmp.conj().T, (ns, k, k)))
        )
        z = jnp.where(it == 0, jnp.broadcast_to(S0, (ns, k, k)),
                      -_smm(Lam, z_prev))
        # C_i = Q_i - C_{i-1} Lambda^H: lanes-major Ct = Qt - conj(Lam) Ct
        Cs = Qt[None] - _smm_f(op, jnp.conj(Lam), Cs)
        Dinv = jax.vmap(chol_inverse_spd)(Delta)
        eta = _smm(Dinv, z)                                  # Delta^{-1} z
        # X_sigma += C eta: lanes-major Xs += eta^T Cs (plain transpose)
        Xs = Xs + _smm_f(op, jnp.swapaxes(eta, 1, 2), Cs)

        # ---- seed SBCGrQ update (shared Krylov engine) --------------------
        alpha_t = jnp.conj(alpha)
        Vt, G = f_mm_update_gram(-alpha_t, Zt, Qt, axis_name, codec=op)
        Mi, Wt, rho = qr_passes_from_gram(G, Vt, qr_passes, axis_name,
                                         codec=op)
        Qt, Pt = f_qr_p_update(Mi, Wt, jnp.conj(rho), Pt, codec=op)

        # shifted residual coefficient: rho_{i+1} M_i eta
        coef = _smm(jnp.broadcast_to(kk_mm(rho, M), (ns, k, k)), eta)
        rel = relres_of(coef)
        if hist is not None:
            hist = hist.at[it].set(jnp.max(rel))
        return (Xs, Cs, Qt, Pt, rho, M, Dinv, z, rel, it + 1, hist)

    def vary(x):
        # Zero-initialized per-shift fields start replicated; the loop body
        # makes them device-varying (they mix with the sharded Q) — align
        # the carry types for shard_map's static collective checking.
        if axis_name is None:
            return x
        return lax.pcast(x, (axis_name,), to="varying")

    zkk = jnp.zeros((k, k), dtype)
    state0 = (
        vary(jnp.zeros((ns,) + Bt.shape, dtype)),    # Xs
        vary(jnp.zeros((ns,) + Bt.shape, dtype)),    # Cs (C_{-1} = 0)
        Q0t,
        Q0t,
        zkk,                                         # rho_0 = 0
        eye,                                         # M_{-1} (unused: rho_0=0)
        jnp.broadcast_to(eye, (ns, k, k)),           # Dinv_{-1} (unused)
        jnp.broadcast_to(S0, (ns, k, k)),            # z_{-1} placeholder
        jnp.full((ns, k), jnp.inf, rdtype),          # rel
        jnp.int32(0),
        hist0,
    )
    (Xs, Cs, Qt, Pt, rho, M, Dinv, z, rel, it, hist) = lax.while_loop(
        cond, body, state0
    )
    info = SolverInfo(
        iterations=it,
        relres=rel,
        converged=rel <= tol_arr,
        matvecs=it,  # Q_0 comes from QR of B directly: no setup apply
        history=hist,
    )
    return Xs, info


def solve_shifted_sbcgrq(
    op: Any,
    B: jax.Array,
    sigmas,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 2,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``(A + sigma_j I) X_j = B`` for all shifts with one Krylov space.

    Args:
      op: SPD/HPD LinearOperator.
      B: (n, k) RHS block (shared by every shift).
      sigmas: (nshift,) non-negative shifts (include 0.0 for the seed).

    Returns:
      (Xs, info): Xs (nshift, n, k); info.relres (nshift, k) per-shift
      per-RHS relative residual norms; matvecs counts SpMMs (one per
      iteration — shared across shifts).
    """
    if B.ndim == 1:
        raise ValueError("solve_shifted_sbcgrq expects an (n, k) block")
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    sig = jnp.atleast_1d(jnp.asarray(sigmas))
    Bt = op.to_internal(B.T)
    Xs, info = _shifted_sbcgrq_impl(
        op, Bt, sig, tol, max_iter, qr_passes, axis_name, record_history
    )
    import numpy as np

    outs = [op.from_internal(Xs[j]).T for j in range(sig.shape[0])]
    if isinstance(outs[0], np.ndarray):  # host complex codec (realified ops)
        return np.stack(outs), info
    return jnp.stack(outs), info
