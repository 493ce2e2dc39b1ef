"""Converged-column deflation for block solvers (T-C4, SURVEY.md §3.2).

O'Leary's variable-block-size device (SURVEY.md §8 hard part 4): once
columns of the RHS block converge, iterating them further wastes SpMM and
update bandwidth — the field traffic is proportional to the block
width k, and with spread-difficulty RHS the worst column can keep the whole
block hot for 2x its useful life.

Shape constraint: XLA wants static shapes, so columns cannot be
dropped inside the jitted ``lax.while_loop``. Instead the solve restarts at
**halving widths**: the inner SBCGrQ stage exits as soon as the number of
unconverged columns reaches half the current width (the ``active_floor``
stop-rule hook in ``_sbcgrq_impl``), the converged columns are frozen, and
the survivors warm-start a stage of half the width. Each restart costs one
extra SpMM (the fresh thin-QR of the true residual — the same cost as a
residual replacement) and each width compiles once (cached thereafter).

Widths are padded to a multiple of ``width_quantum`` (default 8), which
bounds the number of distinct stage widths that compile.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from blockcg.types import SolverInfo
from blockcg.solvers.sbcgrq import solve_sbcgrq


def _ceil_to(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def _deflate_nmin() -> int:
    """Auto-mode row threshold below which halving restarts default OFF on
    high-latency devices (where 8 dispatches take more than 10 ms).

    On such a device the exploratory restart machinery of a small solve
    can cost more than the whole fixed-width solve, even with a healthy
    column cut — the seconds-gate bounds the loss to that first restart
    but cannot eliminate it, because the spread is only observable by
    paying it. Default threshold: 1M rows, overridable via
    BLOCKCG_DEFLATE_NMIN (0 = always on). On a low-latency device the
    latency condition in _deflated_driver keeps halving on at every size.
    """
    import os

    return int(os.environ.get("BLOCKCG_DEFLATE_NMIN", str(1 << 20)))


def solve_sbcgrq_deflated(
    op,
    B: jax.Array,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 1,
    replace_every: int = 0,
    min_width: int = 8,
    width_quantum: int = 8,
    restart_overhead_s: float | None = None,
) -> tuple[jax.Array, SolverInfo]:
    """SBCGrQ with converged-column deflation (width-halving restarts).

    Returns (X, info) like ``solve_sbcgrq``; additionally ``info`` carries
    ``per_rhs_iters`` (iterations each column spent active, summed over
    stages) and ``matvec_cols`` (total SpMM column-passes = sum of
    stage_width x stage_matvecs — the bandwidth-weighted work metric that
    deflation actually reduces). ``tol`` may be a per-RHS (k,) vector;
    ``restart_overhead_s`` gates unprofitable restarts by measured seconds
    (see ``_deflated_driver``; None = measure the dispatch latency).
    """

    def stage(Bs, X0s, budget, floor, tol_s):
        # max_iter fixed (static jit key); the shrinking budget rides the
        # traced iter_cap so every stage at a given width shares one
        # compilation (see _sbcgrq_impl).
        return solve_sbcgrq(
            op, Bs, X0s, tol=tol_s, max_iter=max_iter, iter_cap=budget,
            qr_passes=qr_passes, replace_every=replace_every,
            active_floor=floor,
        )

    return _deflated_driver(stage, B, X0, tol=tol, max_iter=max_iter,
                            min_width=min_width, width_quantum=width_quantum,
                            restart_overhead_s=restart_overhead_s)


@functools.partial(jax.jit, static_argnames=("k_axis",))
def _gather_cols(B, X, idx, mask, k_axis=1):
    """One-dispatch stage repack: ``idx`` is padded to the stage width with
    an out-of-range index (clamped by the gather) and ``mask`` zeroes the
    pad columns. Replaces the zeros/.at[].set/gather chain with a single
    dispatch.

    ``k_axis=0`` is the lanes-major (k, n) variant — the capacity driver
    (solve_refined_lean) deflates without transposing its fields."""
    mk = mask if k_axis == 1 else mask[:, None]
    Bs = jnp.take(B, idx, axis=k_axis, mode="clip") * mk
    X0s = jnp.take(X, idx, axis=k_axis, mode="clip") * mk
    return Bs, X0s


@functools.partial(jax.jit, static_argnames=("k_axis",))
def _scatter_cols(X, D, idx, k_axis=1):
    """One-dispatch stage scatter-back; pad entries of ``idx`` are out of
    range and mode="drop" discards them."""
    if k_axis == 1:
        return X.at[:, idx].set(D, mode="drop")
    return X.at[idx].set(D, mode="drop")


@jax.jit
def _latency_probe(v):
    return v + 1.0


_LATENCY_CACHE: dict = {}


def _dispatch_latency_s() -> float:
    """Measured per-dispatch host->device round-trip (value fetch forced).

    It differs by orders of magnitude between a locally attached device
    and a remote one — which is why the restart gate must measure rather
    than assume. Cached per backend: the probe itself costs a compile + 4
    dispatches, and re-measuring inside every deflated solve would bill
    that to the solve."""
    import time as _time

    key = jax.default_backend()
    hit = _LATENCY_CACHE.get(key)
    if hit is not None:
        return hit
    x = jnp.zeros((8,), jnp.float32)
    _ = float(jnp.sum(_latency_probe(x)))  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = _time.time()
        _ = float(jnp.sum(_latency_probe(x)))
        best = min(best, _time.time() - t0)
    _LATENCY_CACHE[key] = best
    return best


def _deflated_driver(
    stage, B, X0, *, tol, max_iter, min_width, width_quantum,
    restart_overhead_s: float | None = None, k_axis: int = 1,
) -> tuple[jax.Array, SolverInfo]:
    """Width-halving restart loop around a stage solver.

    ``stage(Bs, X0s, budget, floor, tol_s) -> (X, info)`` runs the inner
    SBCGrQ with the ``active_floor`` stop rule; the single-device and the
    row-sharded entry points (parallel/api.py solve_sbcgrq_deflated_dist)
    share this host loop — column subsetting happens on the (n, k)
    API-boundary arrays either way.

    ``tol`` may be a scalar or a per-RHS (k,) vector (per-column targets
    are the textbook spread-convergence case deflation exists for).

    The SECONDS-BASED halving gate (``restart_overhead_s``): a restart
    costs one extra SpMM (the fresh thin-QR) plus ~8 host dispatches; on a
    high-latency device a restart can cost more than the entire remaining
    solve. The driver measures the per-iteration wall cost of the stage
    just run and the device dispatch latency, projects the survivors'
    remaining iterations from their log-residual decay rate, and halves
    only when the projected traffic saving
    ``remaining x per_iter x (1 - w_next/w)`` exceeds the restart cost —
    otherwise it finishes at the current (already-shrunk) width. Pass 0 to
    halve unconditionally; None measures the overhead.
    The one exploratory restart after the first floor-exit is the price of
    observing the convergence spread; the gate bounds the loss to that.
    """
    import time as _time

    k = B.shape[k_axis]
    n = B.shape[1 - k_axis]
    tol_arr = np.broadcast_to(np.asarray(tol, np.float64), (k,))
    tol_stage = tol if np.ndim(tol) == 0 else np.asarray(tol, np.float64)
    if k < 2 * min_width:
        X, info = stage(B, X0, max_iter, 0, tol_stage)
        info.matvec_cols = info.matvecs * k
        return X, info

    if restart_overhead_s is None:
        restart_overhead_s = 8.0 * _dispatch_latency_s()
        # Auto small-n default: on a high-latency device the restart
        # machinery's dispatches dwarf a small solve (see _deflate_nmin);
        # run one fixed-width stage instead.
        # Explicit restart_overhead_s (including 0) bypasses this.
        if n < _deflate_nmin() and restart_overhead_s > 0.01:
            X, info = stage(B, X0, max_iter, 0, tol_stage)
            info.matvec_cols = info.matvecs * k
            return X, info

    # X materializes LAZILY: the first stage runs all k columns, so its
    # repack is the identity — passing B straight through (and X0 as-is)
    # avoids two (k, n) gather copies, which is what lets the capacity
    # driver (solve_refined_lean deflate=True, 16.7M rows) fit: the eager
    # zeros_like(B) + Bs + X0s would cost three extra fields there.
    X = X0
    active = np.arange(k)
    rr_prev = np.ones(k)  # per-column relres at the last stage boundary
    per_rhs = np.zeros(k, np.int64)
    relres_out = np.full(k, np.nan)
    conv_out = np.zeros(k, bool)
    iters_total = 0
    mv_total = 0
    mv_cols = 0
    any_breakdown = False
    allow_floor = True

    while True:
        na = len(active)
        w = _ceil_to(na, width_quantum)
        halving = allow_floor and w > min_width and iters_total < max_iter
        floor = w // 2 if halving else 0
        identity = na == k and w == k
        idx = jnp.asarray(np.pad(active, (0, w - na),
                                 constant_values=k), jnp.int32)
        if identity:
            Bs, X0s = B, X
        else:
            if X is None:
                X = jnp.zeros_like(B)
            mask = jnp.asarray(
                (np.arange(w) < na).astype(np.float32), jnp.real(B).dtype)
            Bs, X0s = _gather_cols(B, X, idx, mask, k_axis=k_axis)
        if np.ndim(tol) == 0:
            tol_s = tol
        else:
            tol_s = np.pad(np.asarray(tol, np.float64)[active],
                           (0, w - na), constant_values=1.0)
        budget = max(max_iter - iters_total, 1)
        t0 = _time.time()
        D, info = stage(Bs, X0s, budget, floor, tol_s)
        stage_iters = int(info.iterations)  # forces the stage's values
        stage_wall = _time.time() - t0
        if identity:
            X = D
        else:
            X = _scatter_cols(X, D, idx, k_axis=k_axis)
        if info.breakdown is not None:
            any_breakdown = any_breakdown or bool(info.breakdown)
        stage_mv = int(info.matvecs)
        iters_total += stage_iters
        mv_total += stage_mv
        mv_cols += stage_mv * w
        pr = np.asarray(info.per_rhs_iters)[:na]
        rr = np.asarray(info.relres)[:na]
        per_rhs[active] += pr
        relres_out[active] = rr
        tol_a = tol_arr[active]
        conv_out[active] = rr <= tol_a
        still_mask = rr > tol_a
        still = active[still_mask]
        if len(still) == 0 or not halving or iters_total >= max_iter:
            break
        if len(still) == na and stage_iters >= budget:
            break  # no progress left in the budget
        # Halving gate: projected remaining SECONDS saved vs restart cost.
        if restart_overhead_s > 0:
            lr_prev = np.log(np.maximum(rr_prev[active], 1e-300))
            lr_now = np.log(np.maximum(rr, 1e-300))
            rate = (lr_prev - lr_now) / max(stage_iters, 1)
            need = lr_now - np.log(np.maximum(tol_a, 1e-300))
            rem = np.where(rate > 1e-12, need / np.maximum(rate, 1e-12),
                           np.inf)
            remaining = float(np.max(rem[still_mask]))
            w_next = _ceil_to(len(still), width_quantum)
            # Per-iteration wall cost at this width, with the stage call's
            # own ~3-dispatch overhead subtracted (repack, solve, fetches).
            per_iter = max(stage_wall - 3.0 * _dispatch_latency_s(),
                           0.0) / max(stage_iters, 1)
            saving = (remaining * per_iter * (1.0 - w_next / w)
                      if np.isfinite(remaining) else float("inf"))
            if saving < restart_overhead_s:
                allow_floor = False  # finish at the next (already-shrunk) width
        rr_prev[active] = rr
        active = still

    info = SolverInfo(
        iterations=jnp.int32(iters_total),
        relres=jnp.asarray(relres_out, jnp.real(B).dtype),
        converged=jnp.asarray(conv_out),
        matvecs=jnp.int32(mv_total),
        per_rhs_iters=jnp.asarray(per_rhs, jnp.int32),
        matvec_cols=jnp.int32(mv_cols),
        breakdown=jnp.asarray(any_breakdown),
    )
    return X, info
