"""BCGdQ — block CG with thin-QR-orthonormalized direction block.

Reference equivalent: the reference README walks Dubrulle's variant ladder
(BIT 41 (2001) "Retooling the method of block conjugate gradients"):
BCG -> BCGA -> BCGdQ -> BCGrQ (SURVEY.md §1.1). The "dQ" device replaces the
search-direction block P by an orthonormal W (thin QR each iteration), which
keeps the k x k Gram ``W^H A W`` well-conditioned even when plain BCG's
``P^H A P`` degenerates as right-hand sides converge. The "rQ" member of the
ladder (residual-block QR) is ``solve_sbcgrq``; ``solve_bcgrq`` aliases it.

Recurrence (A SPD/HPD; W orthonormal n x k):

    R = B - A X0 ;  [W, ~] = thinQR(R)
    loop:
        Z     = A W                       # the hot SpMM
        M     = W^H Z                     # k x k HPD
        alpha = M^{-1} (W^H R)
        X    += W alpha ;  R -= Z alpha
        beta  = -M^{-1} (Z^H R)           # enforces W^H A W_new = 0
        [W, ~] = thinQR(R + W beta)

In exact arithmetic the iterates coincide with O'Leary BCG; the QR replaces
BCG's implicit ``beta = S^{-1} S'`` coupling, trading one extra k x k Gram
per iteration for rank robustness. All (n, k)-sized steps run through the
block-update helpers of solvers/common.py; the QRs need no extra field
passes (their Grams come with the updates).
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
    cholqr_fused_t,
    f_gram,
    f_matmat_gram,
    f_mm_update,
    f_mm_update_gram,
    qr_passes_from_gram,
    row_norms2_t,
)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "qr_passes", "axis_name",
                              "record_history")
)
def _bcgdq_impl(op, Bt, X0t, tol, max_iter, qr_passes, axis_name,
                record_history):
    rdtype = jnp.real(Bt).dtype
    bnorm2 = row_norms2_t(Bt, axis_name, codec=op)
    bnorm2 = jnp.where(bnorm2 > 0, bnorm2, jnp.asarray(1.0, rdtype))
    tol2 = jnp.asarray(tol, rdtype) ** 2 * bnorm2

    R0t = Bt - op.matmat_t(X0t)
    W0t, _ = cholqr_fused_t(R0t, passes=qr_passes, axis_name=axis_name,
                            codec=op)
    S0 = f_gram(R0t, R0t, axis_name, codec=op)
    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    def cond(state):
        _, _, _, S, it, _ = state
        sd = jnp.real(jnp.diag(S))
        return jnp.logical_and(it < max_iter, jnp.any(sd > tol2))

    def body(state):
        Xt, Rt, Wt, S, it, hist = state
        Zt, M = f_matmat_gram(op, Wt, axis_name)  # W^H A W  (k x k HPD)
        g = f_gram(Wt, Rt, axis_name, codec=op)  # W^H R
        alpha = chol_solve_spd(M, g)
        # Lanes-major: X += W alpha  ->  Xt += alpha^T Wt  (plain transpose).
        Xt = f_mm_update(alpha.T, Wt, Xt, codec=op)
        Rt, S_new = f_mm_update_gram(-alpha.T, Zt, Rt, axis_name, codec=op)
        h = f_gram(Zt, Rt, axis_name, codec=op)  # Z^H R
        beta = -chol_solve_spd(M, h)
        Vt, Gv = f_mm_update_gram(beta.T, Wt, Rt, axis_name, codec=op)
        M1, Vt, _rho = qr_passes_from_gram(Gv, Vt, qr_passes, axis_name,
                                           codec=op)
        Wt = f_mm_update(M1, Vt, codec=op)
        if hist is not None:
            hist = hist.at[it].set(
                jnp.sqrt(jnp.max(jnp.real(jnp.diag(S_new)) / bnorm2))
            )
        return (Xt, Rt, Wt, S_new, it + 1, hist)

    Xt, Rt, Wt, S, it, hist = lax.while_loop(
        cond, body, (X0t, R0t, W0t, S0, jnp.int32(0), hist0)
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


def solve_bcgdq(
    op: Any,
    B: jax.Array,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 1,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A X = B`` by block CG with QR'd directions (Dubrulle BCGdQ)."""
    if B.ndim == 1:
        raise ValueError("solve_bcgdq expects an (n, k) block; use solve_cg")
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    Bt = op.to_internal(B.T)
    X0t = jnp.zeros_like(Bt) if X0 is None else op.to_internal(X0.T)
    Xt, info = _bcgdq_impl(
        op, Bt, X0t, tol, max_iter, qr_passes, axis_name, record_history
    )
    return op.from_internal(Xt).T, info
