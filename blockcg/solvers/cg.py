"""CG solver (T-S1). Reference equivalent: R5 (SURVEY.md §3.1, recurrence §1.2).

The iteration is a jitted ``lax.while_loop`` whose state lives entirely on
device; with ``axis_name`` set the same body runs row-sharded under
``shard_map`` (reductions psum, operator does its own halo exchange). State
is a lanes-major single-row field (1, ...) in the operator's internal view,
applied through ``matmat_t`` (no per-apply relayout for block operators).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from blockcg.types import SolverInfo
from blockcg.solvers.common import f_matmat_gram, vdot_real as _vdot


def _to_field(op, v):
    """(n,) vector -> (1, ...) lanes-major internal field."""
    return op.to_internal(v[None, :])


def _from_field(op, f):
    return op.from_internal(f)[0]


@functools.partial(
    jax.jit, static_argnames=("max_iter", "axis_name", "record_history")
)
def _cg_impl(op, b, x0, tol, max_iter, axis_name, record_history):
    """State is a lanes-major single-row field ``(1, ...)`` in the
    operator's internal view (block operators would otherwise pay a lane-
    relayout per apply through the (n,)-vector matvec path)."""
    from blockcg.solvers.common import acc_dtype

    # Scalars (rho, alpha, beta, norms, history) live in the accumulation
    # dtype — f32 for bf16 fields (bf16-tier rule): only the (1, n) fields
    # themselves are stored in the field dtype.
    rdtype = acc_dtype(jnp.real(b).dtype)
    bnorm2 = _vdot(b, b, axis_name)
    bnorm2 = jnp.where(bnorm2 > 0, bnorm2, jnp.asarray(1.0, rdtype))
    tol2 = jnp.asarray(tol, rdtype) ** 2 * bnorm2

    r0 = b - op.matmat_t(x0)
    rho0 = _vdot(r0, r0, axis_name)
    hist0 = (
        jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None
    )

    def cond(state):
        _, _, _, rho, it, _ = state
        return jnp.logical_and(it < max_iter, rho > tol2)

    # Field accumulation dtype: complex stays complex, bf16 widens to f32
    # (rdtype above is the REAL scalar dtype — casting a complex field to
    # it would drop the imaginary part).
    fadt = acc_dtype(b.dtype)

    def axpy(a, s, v):
        # Field update: acc-dtype elementwise math, field-dtype storage
        # (XLA fuses the widen/round into the add — no extra passes;
        # no-op casts for f32/complex fields).
        return (a.astype(fadt) + s * v.astype(fadt)).astype(a.dtype)

    def body(state):
        x, r, p, rho, it, hist = state
        # SpMM with the p^H A p reduction (the (1,1) Gram of the 1-row
        # field, operators/base.py matmat_gram_t).
        z, M = f_matmat_gram(op, p, axis_name)
        denom = jnp.real(M[0, 0]).astype(rdtype)
        alpha = rho / denom
        x = axpy(x, alpha, p)
        r = axpy(r, -alpha, z)
        rho_new = _vdot(r, r, axis_name)
        beta = rho_new / rho
        p = axpy(r, beta, p)
        if hist is not None:
            hist = hist.at[it].set(jnp.sqrt(rho_new / bnorm2))
        return (x, r, p, rho_new, it + 1, hist)

    x, r, p, rho, it, hist = lax.while_loop(
        cond, body, (x0, r0, r0, rho0, jnp.int32(0), hist0)
    )
    relres = jnp.sqrt(rho / bnorm2)[None]
    info = SolverInfo(
        iterations=it,
        relres=relres,
        converged=relres <= tol,
        matvecs=it + 1,
        history=hist,
    )
    return x, info


def solve_cg(
    op: Any,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A x = b`` (A SPD) by conjugate gradients.

    Args:
      op: LinearOperator pytree (blockcg.operators).
      b: (n,) or (n, 1) right-hand side.
      x0: optional initial guess (defaults to zero).
      tol: relative residual target ``||r|| <= tol * ||b||``.
      max_iter: iteration cap (static: sizes the optional history buffer).
      axis_name: set when running row-sharded inside ``shard_map``.

    Returns:
      (x, SolverInfo), x shaped like b.
    """
    unsqueeze = b.ndim == 2
    if unsqueeze:
        if b.shape[1] != 1:
            raise ValueError("solve_cg is single-RHS; use solve_bcg/solve_sbcgrq")
        b = b[:, 0]
        if x0 is not None:
            x0 = x0[:, 0]
    bf = _to_field(op, b)
    x0f = jnp.zeros_like(bf) if x0 is None else _to_field(op, x0)
    xf, info = _cg_impl(op, bf, x0f, tol, max_iter, axis_name, record_history)
    x = _from_field(op, xf)
    return (x[:, None] if unsqueeze else x), info
