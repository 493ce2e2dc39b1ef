"""Block CG solver (T-S2), O'Leary 1980. Reference equivalent: R6
(SURVEY.md §3.1, recurrence §1.2): all k right-hand sides share one block
Krylov space; the per-iteration coefficients are k x k SPD solves.

Internal layout is lanes-major (k, n): see solvers/common.py. The §1.2
recurrence transposes to:

    Xt += alpha^T Pt ;  Rt -= alpha^T Zt ;  Pt = Rt + beta^T Pt
"""

from __future__ import annotations

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
    f_xr_update_gram,
    row_norms2_t,
)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "axis_name", "record_history")
)
def _bcg_impl(op, Bt, X0t, tol, max_iter, axis_name, record_history):
    rdtype = jnp.real(Bt).dtype
    bnorm2 = row_norms2_t(Bt, axis_name, codec=op)
    bnorm2 = jnp.where(bnorm2 > 0, bnorm2, jnp.asarray(1.0, rdtype))
    tol2 = jnp.asarray(tol, rdtype) ** 2 * bnorm2

    R0t = Bt - op.matmat_t(X0t)
    S0 = f_gram(R0t, R0t, axis_name, codec=op)
    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    def cond(state):
        _, _, _, S, it, _ = state
        sd = jnp.real(jnp.diag(S))  # S = R^H R: diagonal is real
        return jnp.logical_and(it < max_iter, jnp.any(sd > tol2))

    def body(state):
        Xt, Rt, Pt, S, it, hist = state
        Zt, M = f_matmat_gram(op, Pt, axis_name)  # Z = A P, M = P^T A P
        alpha = chol_solve_spd(M, S)  # M alpha = S
        # X+R updates with the next Gram S' = R R^T.
        Xt, Rt, S_new = f_xr_update_gram(alpha.T, Pt, Xt, Zt, Rt,
                                         axis_name, codec=op)
        beta = chol_solve_spd(S, S_new)  # S beta = S'
        Pt = f_mm_update(beta.T, Pt, Rt, codec=op)
        if hist is not None:
            hist = hist.at[it].set(
                jnp.sqrt(jnp.max(jnp.real(jnp.diag(S_new)) / bnorm2))
            )
        return (Xt, Rt, Pt, S_new, it + 1, hist)

    Xt, Rt, Pt, S, it, hist = lax.while_loop(
        cond, body, (X0t, R0t, R0t, S0, jnp.int32(0), hist0)
    )
    relres = jnp.sqrt(jnp.real(jnp.diag(S)) / bnorm2)
    info = SolverInfo(
        iterations=it,
        relres=relres,
        converged=relres <= tol,
        matvecs=it + 1,
        history=hist,
    )
    return Xt, info


def solve_bcg(
    op: Any,
    B: jax.Array,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A X = B`` (A SPD, B an (n, k) block) by O'Leary block CG.

    Convergence rule matches the reference: every RHS must satisfy
    ``||R e_j|| <= tol * ||B e_j||`` (SURVEY.md §1.2). Prefer
    ``solve_sbcgrq`` when k is large or iteration counts are high — plain BCG
    loses rank in the Gram matrices as columns converge.
    """
    if B.ndim == 1:
        raise ValueError("solve_bcg expects an (n, k) block; use solve_cg for k=1")
    # State in the operator's internal field view (see solve_sbcgrq).
    Bt = op.to_internal(B.T)
    X0t = jnp.zeros_like(Bt) if X0 is None else op.to_internal(X0.T)
    Xt, info = _bcg_impl(op, Bt, X0t, tol, max_iter, axis_name, record_history)
    return op.from_internal(Xt).T, info
