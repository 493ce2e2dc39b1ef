"""Multi-shift CG (T-S4; reference R8 equivalent, SURVEY.md §1.1/§3.1).

Solves ``(A + sigma_j I) x_j = b`` for many shifts sigma_j >= 0 with ONE
Krylov space — one SpMV per iteration total, plus O(nshift) scalar
recurrences and (nshift, n) vector updates. Standard lattice-QCD machinery
(B. Jegerlehner, hep-lat/9612014, "Krylov space solvers for shifted linear
systems"): the shifted residuals stay collinear with the seed residual,
``r_sigma^i = zeta_sigma^i r^i``, and the zeta factors obey a three-term
scalar recurrence.

Seed system is sigma = 0 (A itself). Shift state carries a leading
``nshift`` axis over the lanes-major (n,) vectors (SURVEY.md §1.2 "shifted
extension": a leading-dimension change, not a rewrite).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from blockcg.types import SolverInfo
from blockcg.solvers.common import (f_matmat_gram, psum_if,
                                        row_norms2_t)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "axis_name", "record_history")
)
def _shifted_cg_impl(op, b, sigmas, tol, max_iter, axis_name, record_history):
    """``b`` is a lanes-major single-row field ``(1, ...)`` in the operator's
    internal view (block operators would otherwise pay a lane relayout per
    apply — see solvers/cg.py); per-shift state carries a leading nshift
    axis over it."""
    dtype = b.dtype
    rdtype = jnp.real(b).dtype
    nshift = sigmas.shape[0]
    fdims = (slice(None),) + (None,) * b.ndim  # broadcast (nshift,) -> fields
    bnorm2 = row_norms2_t(b, axis_name, codec=op)[0]
    bnorm2 = jnp.where(bnorm2 > 0, bnorm2, jnp.asarray(1.0, rdtype))
    tol2 = jnp.asarray(tol, rdtype) ** 2 * bnorm2

    r0 = b
    p0 = b
    rho0 = bnorm2
    xs0 = jnp.zeros((nshift,) + b.shape, dtype)
    ps0 = jnp.broadcast_to(b, (nshift,) + b.shape).astype(dtype)
    # The shift recurrence scalars (zeta, alpha, beta) are REAL for
    # Hermitian A and real shifts — only the vectors carry the dtype.
    zeta0 = jnp.ones((nshift,), rdtype)   # zeta^i
    zeta_m0 = jnp.ones((nshift,), rdtype)  # zeta^{i-1}
    # Per-shift squared residual norms, CARRIED so frozen (converged)
    # shifts keep reporting the norm at which they froze (recomputing
    # zeta^2 rho at exit would keep shrinking with the still-iterating
    # seed and underreport frozen shifts by orders of magnitude).
    res20 = jnp.full((nshift,), bnorm2, rdtype)
    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    state0 = (
        xs0, ps0, r0, p0, rho0, zeta0, zeta_m0,
        jnp.asarray(1.0, rdtype), jnp.asarray(0.0, rdtype), res20,
        jnp.int32(0), hist0,
    )

    def cond(state):
        res2, it = state[9], state[10]
        return jnp.logical_and(it < max_iter, jnp.any(res2 > tol2))

    def body(state):
        xs, ps, r, p, rho, zeta, zeta_m, a_old, b_old, res2, it, hist = state
        # SpMM with the p^H A p reduction (real for Hermitian A —
        # f_matmat_gram's Gram is conjugated).
        z, M = f_matmat_gram(op, p, axis_name)
        denom = jnp.real(M[0, 0])
        alpha = rho / denom
        # zeta recurrence (Jegerlehner eq. (2.44)-style, seed sigma = 0)
        num = zeta * zeta_m * a_old
        den = alpha * b_old * (zeta_m - zeta) + zeta_m * a_old * (1.0 + sigmas * alpha)
        zeta_new = num / den
        alpha_s = alpha * zeta_new / zeta

        # freeze converged shifts (their zeta/den can degenerate)
        active = res2 > tol2
        zeta_new = jnp.where(active, zeta_new, zeta)
        alpha_s = jnp.where(active, alpha_s, 0.0)

        xs = xs + alpha_s[fdims] * ps
        r_new = r - alpha * z
        rho_new = row_norms2_t(r_new, axis_name, codec=op)[0]
        beta = rho_new / rho
        beta_s = beta * (zeta_new / zeta) ** 2
        ps = zeta_new[fdims] * r_new[None] + beta_s[fdims] * ps
        p_new = r_new + beta * p
        res2 = jnp.where(active, zeta_new * zeta_new * rho_new, res2)
        if hist is not None:
            hist = hist.at[it].set(jnp.sqrt(jnp.max(res2) / bnorm2))
        return (
            xs, ps, r_new, p_new, rho_new, zeta_new, zeta, alpha, beta,
            res2, it + 1, hist,
        )

    state = lax.while_loop(cond, body, state0)
    xs, res2, it, hist = state[0], state[9], state[10], state[11]
    relres = jnp.sqrt(res2 / bnorm2)
    info = SolverInfo(
        iterations=it,
        relres=relres,
        converged=relres <= tol,
        matvecs=it,
        history=hist,
    )
    return xs, info


def solve_shifted_cg(
    op: Any,
    b: jax.Array,
    sigmas,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``(A + sigma_j I) x_j = b`` for all shifts at once.

    Args:
      op: SPD LinearOperator (the unshifted A — the seed system).
      b: (n,) right-hand side.
      sigmas: (nshift,) shifts, each >= 0.

    Returns:
      (X, info): X is (n, nshift); ``info.relres``/``converged`` are
      per-shift.
    """
    if b.ndim != 1:
        raise ValueError("solve_shifted_cg expects a single (n,) RHS")
    sig = jnp.asarray(sigmas, dtype=jnp.real(b).dtype)
    bf = op.to_internal(b[None, :])
    xs, info = _shifted_cg_impl(
        op, bf, sig, tol, max_iter, axis_name, record_history
    )
    cols = [op.from_internal(xs[j])[0] for j in range(sig.shape[0])]
    if isinstance(cols[0], np.ndarray):  # host complex codec (realified ops)
        import numpy as _np

        return _np.stack(cols, axis=1), info
    return jnp.stack(cols, axis=1), info
