"""Chebyshev-preconditioned block solves (beyond the reference).

``solve_sbcgrq_cheb`` runs SBCGrQ on the commuting-preconditioned system
(M A) X = M B with M = p_d(A) (operators/cheb.py): iteration counts drop
(104 -> 41 at degree 6 on config 3, k=32) at the price of more total SpMMs
(246 vs 104 — block CG with many RHS is already near matvec-optimal, so a
fixed polynomial cannot beat it on raw matvecs). On a single device the
extra applies can outweigh the saved iterations; the feature exists for the
regime it is built for: **latency-bound distributed solves**, where
each iteration costs fixed collective/dispatch latency and d-fold fewer
iterations means d-fold fewer psum/halo rounds (the classic communication-
avoiding trade). For distributed use pass ``spectrum=`` explicitly (the
power-iteration estimator is single-device).

Practical notes:
- The spectral bounds are estimated ONCE per operator (cached) by power
  iteration. The lo bound intentionally lands ABOVE lambda_min: p(t)t > 0
  for every t > 0 regardless (q(0) = 1 and q decreases), the bulk spectrum
  above lo gets tightly clustered, and the handful of modes below lo are
  exactly what a block solver deflates fastest — measured better than the
  exact-[lambda_min, lambda_max] polynomial.
- The inner solver monitors the PRECONDITIONED residual; every outer cycle
  is ONE jitted program (true residual -> rhs transform -> inner solve ->
  update -> new true residual), so certification costs no eager dispatches.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

from blockcg.types import SolverInfo
from blockcg.operators.cheb import ChebyshevOperator, estimate_spectrum
from blockcg.solvers.sbcgrq import _sbcgrq_impl
from blockcg.solvers.common import row_norms2_t

import weakref

# Keyed by id() with a weakref finalizer evicting the entry when the
# operator is collected (so recycled ids can't serve stale spectra).
# WeakKeyDictionary would need hashable keys; operator dataclasses aren't.
_SPECTRUM_CACHE: dict = {}


@functools.partial(
    jax.jit, static_argnames=("max_iter", "qr_passes", "axis_name",
                              "record_history")
)
def _cheb_cycle(pop, Bt, Xt, bnorm, tol, max_iter, qr_passes, axis_name,
                record_history):
    """One certified cycle on lanes-major internal fields:
    true residual -> M r -> inner SBCGrQ on (MA) D = M r -> X += D."""
    base = pop.base
    Rt = Bt - base.matmat_t(Xt)
    MRt = pop.apply_m_t(Rt)
    Dt, info = _sbcgrq_impl(
        pop, MRt, jnp.zeros_like(MRt), tol, max_iter, qr_passes, 0,
        axis_name, record_history,
    )
    Xt = Xt + Dt
    relres = jnp.sqrt(
        row_norms2_t(Bt - base.matmat_t(Xt), axis_name, codec=base)) / bnorm
    return Xt, relres, info


def solve_sbcgrq_cheb(
    op: Any,
    B: jax.Array,
    *,
    degree: int = 4,
    spectrum: tuple | None = None,
    tol: float = 1e-6,
    max_iter: int = 1000,
    max_cycles: int = 3,
    qr_passes: int = 2,
    axis_name: str | None = None,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A X = B`` by Chebyshev-preconditioned SBCGrQ.

    Returns (X, info): info.relres is the TRUE relative residual;
    info.iterations sums inner iterations over outer cycles; info.matvecs
    counts actual SpMMs (inner applies, rhs transforms, and outer
    true-residual checks); info.history (if recorded) covers the LAST
    cycle only. For row-sharded use inside shard_map set ``axis_name``
    AND pass ``spectrum=`` explicitly (the power-iteration estimator is
    single-device)."""
    if axis_name is not None and spectrum is None:
        raise ValueError(
            "distributed solve_sbcgrq_cheb requires an explicit spectrum= "
            "(the power-iteration estimator is single-device)"
        )
    if max_cycles < 1:
        raise ValueError("max_cycles must be >= 1")
    if spectrum is not None:
        lo = jnp.asarray(spectrum[0], jnp.float32)
        hi = jnp.asarray(spectrum[1], jnp.float32)
    else:
        cached = _SPECTRUM_CACHE.get(id(op))
        if cached is None:
            cached = estimate_spectrum(op)
            try:
                weakref.finalize(op, _SPECTRUM_CACHE.pop, id(op), None)
                _SPECTRUM_CACHE[id(op)] = cached
            except TypeError:  # non-weakrefable operator: skip caching
                pass
        lo, hi = cached
    pop = ChebyshevOperator(base=op, lo=lo, hi=hi, degree=degree)

    Bt = op.to_internal(B.T)
    bnorm = jnp.sqrt(row_norms2_t(Bt, axis_name, codec=op))
    bnorm = jnp.where(bnorm > 0, bnorm, 1.0)
    Xt = jnp.zeros_like(Bt)
    iters = 0
    matvecs = 0
    relres = None
    for _ in range(max_cycles):
        Xt, relres, info = _cheb_cycle(
            pop, Bt, Xt, bnorm, tol, max_iter, qr_passes, axis_name,
            record_history
        )
        iters += int(info.iterations)
        # per cycle: 2 true-residual applies + (degree - 1) SpMMs in the
        # M*r rhs transform + degree SpMMs per inner preconditioned apply
        matvecs += 2 + (degree - 1) + int(info.matvecs) * degree
        if bool(jnp.max(relres) <= tol):
            break
    info = SolverInfo(
        iterations=jnp.int32(iters),
        relres=relres,
        converged=relres <= tol,
        matvecs=jnp.int32(matvecs),
        history=info.history,
    )
    return op.from_internal(Xt).T, info
