"""BCGA — block CG with A-ORTHONORMAL directions (Dubrulle 2001).

The remaining rung of the Dubrulle variant ladder (SURVEY.md §1.1;
DESIGN.md §6 maps the others: BCG = plain, BCGdQ = thin-QR'd directions,
SBCGrQ/BCGrQ = thin-QR'd residuals). BCGA normalizes the direction block
in the A-inner product each iteration,

    M = P^H A P = L L^H ;   P~ = P L^{-H} ,  Z~ = A P~ = Z L^{-H},

after which the coefficient systems trivialize (P~^H A P~ = I):

    alpha = P~^H R ;  X += P~ alpha ;  R -= Z~ alpha
    beta  = -Z~^H R ;  P_next = R + P~ beta.

In exact arithmetic this is BCG in a different round-off path — the
point of the rung is that the normalized directions cannot grow/collapse
in scale, so the k x k algebra stays well-conditioned without BCGdQ's
extra thin-QR machinery. The normalization is MATERIALIZED (P~, Z~ are
formed — ~8 extra field passes per iteration vs BCG: the two
normalization passes plus the two alpha/beta grams that BCG's k x k
recurrences get for free) — substituting
L^{-H} into the coefficients instead would be algebraically identical
but reproduce BCG's round-off, defeating the variant. Prefer
``solve_sbcgrq`` for production; this rung exists for ladder parity and
as a numerics cross-check.

Reference equivalent: R6/R8 family (SURVEY.md §3.1); recurrence form per
Dubrulle, BIT 41 (2001), "Retooling the method of block conjugate
gradients".
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from blockcg.types import SolverInfo
from blockcg.solvers.common import (
    f_gram,
    f_matmat_gram,
    f_mm_update,
    f_xr_update_gram,
    row_norms2_t,
    safe_cholesky,
)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "axis_name", "record_history")
)
def _bcga_impl(op, Bt, X0t, tol, max_iter, axis_name, record_history):
    rdtype = jnp.real(Bt).dtype
    bnorm2 = row_norms2_t(Bt, axis_name, codec=op)
    bnorm2 = jnp.where(bnorm2 > 0, bnorm2, jnp.asarray(1.0, rdtype))
    tol2 = jnp.asarray(tol, rdtype) ** 2 * bnorm2

    R0t = Bt - op.matmat_t(X0t)
    S0 = f_gram(R0t, R0t, axis_name, codec=op)
    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    k = S0.shape[0]
    eye = jnp.eye(k, dtype=S0.dtype)

    def cond(state):
        _, _, _, S, it, _ = state
        sd = jnp.real(jnp.diag(S))
        return jnp.logical_and(it < max_iter, jnp.any(sd > tol2))

    def body(state):
        Xt, Rt, Pt, S, it, hist = state
        Zt, M = f_matmat_gram(op, Pt, axis_name)  # Z = A P, M = P^H A P
        # A-orthonormalize: M = L L^H; P~ = P L^{-H} (lanes-major:
        # P~t = conj(L)^{-1} Pt — one k x k triangular inverse, applied to
        # the fields as plain matmuls). Z~ rides the same transform, so
        # no second SpMM.
        L = safe_cholesky(M)
        G1 = jax.scipy.linalg.solve_triangular(jnp.conj(L), eye, lower=True)
        Pn_t = f_mm_update(G1, Pt, codec=op)   # P~
        Zn_t = f_mm_update(G1, Zt, codec=op)   # Z~
        alpha = f_gram(Pn_t, Rt, axis_name, codec=op)      # P~^H R
        # X+R updates with the next Gram.
        Xt, Rt, S_new = f_xr_update_gram(alpha.T, Pn_t, Xt, Zn_t, Rt,
                                         axis_name, codec=op)
        beta = -f_gram(Zn_t, Rt, axis_name, codec=op)      # -Z~^H R_new
        Pt = f_mm_update(beta.T, Pn_t, Rt, codec=op)
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


def solve_bcga(
    op: Any,
    B: jax.Array,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A X = B`` by BCGA — block CG with A-orthonormal directions.

    Same convergence rule as ``solve_bcg`` (every RHS to
    ``||R e_j|| <= tol ||B e_j||``); ~8 extra field passes per iteration
    buy scale-stable directions. See the module docstring for when to
    prefer which ladder rung.
    """
    if B.ndim == 1:
        raise ValueError(
            "solve_bcga expects an (n, k) block; use solve_cg for k=1")
    Bt = op.to_internal(B.T)
    X0t = jnp.zeros_like(Bt) if X0 is None else op.to_internal(X0.T)
    Xt, info = _bcga_impl(op, Bt, X0t, tol, max_iter, axis_name,
                          record_history)
    return op.from_internal(Xt).T, info
