"""Preconditioned block CG (O'Leary 1980, preconditioned form).

The reference's BCG family with a general SPD preconditioner M ~ A^{-1}
(applied as an operator — no factorization needed):

    R = B - A X ;  Z = M R ;  P = Z ;  S = Z^H R
    loop:
        W     = A P                       # hot SpMM
        alpha = (P^H W)^{-1} S
        X    += P alpha ;  R -= W alpha
        Z     = M R
        S'    = Z^H R ;  beta = S^{-1} S' ;  S = S'
        P     = Z + P beta

Complements the structural preconditioners (even-odd Schur,
problems/dirac_eo.py) and the commuting polynomial one (solve_sbcgrq_cheb):
M here is arbitrary SPD — e.g. Jacobi/diagonal scaling for badly
equilibrated systems (``jacobi_preconditioner``), or any user operator.

M must act on the SAME internal field view as ``op`` (build it with
``jacobi_preconditioner(op)``, or wrap a custom operator sharing
``op.to_internal``). Convergence is monitored on the TRUE residual norms
(diag of the fused R R^H Gram — no extra field pass).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from blockcg.types import SolverInfo
from blockcg.solvers.common import (
    chol_solve_spd,
    f_gram,
    f_matmat_gram,
    f_mm_update,
    f_mm_update_gram,
    row_norms2_t,
)


@dataclasses.dataclass
class JacobiPreconditioner:
    """Elementwise M = diag(A)^{-1} in the owning operator's internal field
    layout: ``dinv_int`` is the inverse-diagonal already converted (and for
    merged spin-major block layouts, repeated over the k rows per spin)."""

    dinv_int: jax.Array

    def apply_t(self, Ft: jax.Array) -> jax.Array:
        d = self.dinv_int
        if d.shape[0] != Ft.shape[0]:
            # merged layouts: per-spin rows repeat over the k index
            k = Ft.shape[0] // d.shape[0]
            d = jnp.repeat(d, k, axis=0)
        return Ft * d


jax.tree_util.register_dataclass(
    JacobiPreconditioner, data_fields=["dinv_int"], meta_fields=[]
)


def jacobi_preconditioner(op) -> JacobiPreconditioner:
    """diag(A)^{-1} for operators exposing their diagonal: DIAOperator
    (offset-0 diagonal), ConstBlockDIAOperator with a scalar diagonal hop,
    and DenseOperator."""
    import numpy as np

    from blockcg.operators.cbdia import ConstBlockDIAOperator
    from blockcg.operators.dense import DenseOperator
    from blockcg.operators.dia import DIAOperator

    if isinstance(op, DIAOperator):
        if 0 not in op.offsets:
            raise ValueError("operator has no main diagonal")
        d = op.diags[op.offsets.index(0)]
        return JacobiPreconditioner(dinv_int=(1.0 / d)[None, :])
    if isinstance(op, DenseOperator):
        d = jnp.diagonal(op.A)
        return JacobiPreconditioner(dinv_int=(1.0 / d)[None, :])
    if isinstance(op, ConstBlockDIAOperator):
        if 0 not in op.offsets:
            raise ValueError("operator has no site-diagonal hop")
        d0 = op.offsets.index(0)
        h = np.asarray(op.hops[d0])
        if not np.allclose(h, np.diag(np.diag(h))) or np.ptp(np.diag(h)) != 0:
            raise ValueError(
                "ConstBlockDIA diagonal hop is not a scalar multiple of I; "
                "provide a custom preconditioner"
            )
        c = float(np.diag(h)[0])
        ms = op.mask_slot[d0]
        if ms >= 0:
            dvec = c * op.masks[ms]
            dinv = jnp.where(dvec != 0, 1.0 / dvec, 0.0)
        else:
            dinv = jnp.full((op.ns,), 1.0 / c, dtype=jnp.float32)
        # merged spin-major (m, ns): one row per spin, repeated over k at
        # apply time (JacobiPreconditioner.apply_t)
        return JacobiPreconditioner(
            dinv_int=jnp.broadcast_to(dinv[None, :], (op.bs, op.ns))
        )
    raise TypeError(
        f"jacobi_preconditioner: unsupported operator {type(op).__name__}"
    )


def _apply_m(M, Ft):
    if hasattr(M, "apply_t"):
        return M.apply_t(Ft)
    return M.matmat_t(Ft)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "axis_name", "record_history")
)
def _pbcg_impl(op, M, Bt, X0t, tol, max_iter, axis_name, record_history):
    rdtype = jnp.real(Bt).dtype
    bnorm2 = row_norms2_t(Bt, axis_name, codec=op)
    bnorm2 = jnp.where(bnorm2 > 0, bnorm2, jnp.asarray(1.0, rdtype))
    tol2 = jnp.asarray(tol, rdtype) ** 2 * bnorm2

    R0t = Bt - op.matmat_t(X0t)
    Z0t = _apply_m(M, R0t)
    S0 = f_gram(Z0t, R0t, axis_name, codec=op)
    res20 = row_norms2_t(R0t, axis_name, codec=op)
    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    def cond(state):
        res2, it = state[5], state[6]
        return jnp.logical_and(it < max_iter, jnp.any(res2 > tol2))

    def body(state):
        Xt, Rt, Pt, Zt, S, res2, it, hist = state
        Wt, T = f_matmat_gram(op, Pt, axis_name)   # W = A P, T = P^H A P
        alpha = chol_solve_spd(T, S)
        Xt = f_mm_update(alpha.T, Pt, Xt, codec=op)
        # R update fused with its Gram: diag(R R^H) = true residual norms.
        Rt, RR = f_mm_update_gram(-alpha.T, Wt, Rt, axis_name, codec=op)
        res2 = jnp.real(jnp.diagonal(RR))
        Zt = _apply_m(M, Rt)
        S_new = f_gram(Zt, Rt, axis_name, codec=op)
        beta = chol_solve_spd(S, S_new)
        Pt = f_mm_update(beta.T, Pt, Zt, codec=op)
        if hist is not None:
            hist = hist.at[it].set(jnp.sqrt(jnp.max(res2 / bnorm2)))
        return (Xt, Rt, Pt, Zt, S_new, res2, it + 1, hist)

    state0 = (X0t, R0t, Z0t, Z0t, S0, res20, jnp.int32(0), hist0)
    Xt, Rt, Pt, Zt, S, res2, it, hist = lax.while_loop(cond, body, state0)
    relres = jnp.sqrt(res2 / bnorm2)
    info = SolverInfo(
        iterations=it,
        relres=relres,
        converged=relres <= tol,
        matvecs=it + 1,
        history=hist,
    )
    return Xt, info


def solve_pbcg(
    op: Any,
    B: jax.Array,
    M: Any,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A X = B`` by preconditioned block CG with SPD ``M ~ A^{-1}``.

    ``M`` is a JacobiPreconditioner (``jacobi_preconditioner(op)``) or any
    object with ``apply_t``/``matmat_t`` acting on ``op``'s internal field
    view. Without preconditioning use ``solve_bcg``."""
    if B.ndim == 1:
        raise ValueError("solve_pbcg expects an (n, k) block; use solve_cg")
    Bt = op.to_internal(B.T)
    X0t = jnp.zeros_like(Bt) if X0 is None else op.to_internal(X0.T)
    Xt, info = _pbcg_impl(
        op, M, Bt, X0t, tol, max_iter, axis_name, record_history
    )
    return op.from_internal(Xt).T, info


@functools.partial(
    jax.jit, static_argnames=("max_iter", "qr_passes", "axis_name",
                              "record_history")
)
def _psbcgrq_impl(op, M, Bt, X0t, tol, max_iter, qr_passes, axis_name,
                  record_history):
    """Preconditioned SBCGrQ: Dubrulle's rQ stabilization carried out in
    the M-inner product. Residuals factor as R = Q S with Q^H M Q = I
    (M-CholQR: G = V^H (M V), Q = V L^{-H}); the direction seed becomes
    P = M Q + P rho^H. Reduces exactly to SBCGrQ at M = I and to PCG at
    k = 1. The free per-RHS monitor ||S e_j|| is the M-NORM of the
    residual, reported relative to ||B_j||_M."""
    rdtype = jnp.real(Bt).dtype
    MB = _apply_m(M, Bt)
    bnorm = jnp.sqrt(jnp.maximum(
        jnp.real(jnp.diagonal(f_gram(Bt, MB, axis_name, codec=op))), 0.0))
    bnorm = jnp.where(bnorm > 0, bnorm, jnp.asarray(1.0, rdtype))
    tol_arr = jnp.asarray(tol, rdtype)

    from blockcg.solvers.common import (
        chol_inverse_spd, kk_mm, qr_factors_from_gram,
    )

    def cholqr_m(Vt, passes):
        """M-inner-product CholeskyQR: returns (Qt, MQt, R) with
        Q^H M Q = I and V = Q R. MQ comes free via linearity of M."""
        rho = None
        Qt, MQt = Vt, _apply_m(M, Vt)
        for p in range(passes):
            G = f_gram(Qt, MQt, axis_name, codec=op)
            Mi, Ri = qr_factors_from_gram(G)
            rho = Ri if rho is None else kk_mm(Ri, rho)
            Qt = f_mm_update(Mi, Qt, codec=op)
            if p < passes - 1:
                MQt = _apply_m(M, Qt)  # re-measure (CholeskyQR2 semantics)
            else:
                MQt = f_mm_update(Mi, MQt, codec=op)  # M Q = Mi (M V)
        return Qt, MQt, rho

    def fresh(Xt):
        Rt = Bt - op.matmat_t(Xt)
        Qt, MQt, S = cholqr_m(Rt, qr_passes)
        return Qt, MQt, S

    Q0t, MQ0t, S0 = fresh(X0t)
    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    def relres_of(S):
        return jnp.sqrt(jnp.sum(jnp.real(S * jnp.conj(S)), axis=0)) / bnorm

    def cond(state):
        S, it = state[2], state[4]
        return jnp.logical_and(it < max_iter, jnp.any(relres_of(S) > tol_arr))

    def body(state):
        Xt, Qt, S, Pt, it, hist = state
        Wt, T = f_matmat_gram(op, Pt, axis_name)   # W = A P, T = P^H A P
        alpha = chol_inverse_spd(T)
        alpha_t = jnp.conj(alpha)
        Xt = f_mm_update(kk_mm(S.T, alpha_t), Pt, Xt, codec=op)
        Vt = f_mm_update(-alpha_t, Wt, Qt, codec=op)   # Q - W alpha
        Qt, MQt, rho = cholqr_m(Vt, qr_passes)
        S = kk_mm(rho, S)
        Pt = f_mm_update(jnp.conj(rho), Pt, MQt, codec=op)  # M Q + P rho^H
        if hist is not None:
            hist = hist.at[it].set(jnp.max(relres_of(S)))
        return (Xt, Qt, S, Pt, it + 1, hist)

    state0 = (X0t, Q0t, S0, MQ0t, jnp.int32(0), hist0)
    Xt, Qt, S, Pt, it, hist = lax.while_loop(cond, body, state0)
    relres = relres_of(S)
    info = SolverInfo(
        iterations=it,
        relres=relres,
        converged=relres <= tol_arr,
        matvecs=it + 1,
        history=hist,
    )
    return Xt, info


def solve_psbcgrq(
    op: Any,
    B: jax.Array,
    M: Any,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 2,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Preconditioned stabilized block CG: SBCGrQ with its thin QR carried
    out in the M-inner product (M SPD, applied as an operator). Convergence
    is monitored in the M-norm. Reduces to ``solve_sbcgrq`` at M = I."""
    if B.ndim == 1:
        raise ValueError("solve_psbcgrq expects an (n, k) block")
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    Bt = op.to_internal(B.T)
    X0t = jnp.zeros_like(Bt) if X0 is None else op.to_internal(X0.T)
    Xt, info = _psbcgrq_impl(
        op, M, Bt, X0t, tol, max_iter, qr_passes, axis_name, record_history
    )
    return op.from_internal(Xt).T, info
