"""Mixed-precision iterative refinement to 1e-10 (T-C5; SURVEY.md §8 #1).

f32 epsilon is ~1.2e-7, so a single f32 Krylov solve cannot reach the
north-star tolerance of 1e-10, and an all-f64 solve moves twice the bytes
per iteration. The standard, defensible route (SURVEY.md hard part #1) is
iterative refinement:

    X = 0 (f64)
    repeat:
        R = B - A X           # true residual in f64 (one SpMM per cycle,
                              #   off the hot path)
        stop if max_j ||R e_j|| / ||B e_j|| <= tol
        D = inner_solve(A_f32, R_f32, tol=inner_tol)   # hot f32 SBCGrQ
        X += D

Each cycle contracts the residual by roughly ``inner_tol`` (plus a
kappa(A)*eps_32 floor per cycle), so 1e-10 takes 2–3 cycles at
inner_tol=1e-5. The residual-replacement machinery inside SBCGrQ
(replace_every) is the same mechanism applied within a cycle.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from blockcg.types import SolverInfo
from blockcg.operators.base import astype as op_astype
from blockcg.solvers.sbcgrq import solve_sbcgrq
from blockcg.solvers.bcg import solve_bcg


@functools.partial(jax.jit, static_argnames=("compute_dtype",))
def _refine_cycle(op64, X, D, scale, B64, bnorm, compute_dtype):
    """One compiled outer-refinement program (f64): apply the previous
    cycle's correction, recompute the true residual, rescale it per-RHS,
    and cast the next inner RHS — one dispatch per cycle instead of an
    eager chain (same pattern as poly.py:_cheb_cycle). First cycle passes
    D = 0."""
    X = X + D.astype(X.dtype) * scale[None, :]
    R = B64 - op64.matmat(X)
    nrm = jnp.linalg.norm(R, axis=0)
    relres = nrm / bnorm
    sc = jnp.where(nrm > 0, nrm, jnp.ones_like(nrm))
    R_next = (R / sc[None, :]).astype(compute_dtype)
    return X, R_next, sc, relres


def solve_refined(
    op,
    B: jax.Array,
    *,
    tol: float = 1e-10,
    inner_tol: float = 1e-5,
    max_cycles: int = 8,
    inner_solver: str = "sbcgrq",
    inner_max_iter: int = 2000,
    qr_passes: int = 2,
    replace_every: int = 0,
    solve_fn: Callable | None = None,
    op64=None,
    outer_dtype=None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A X = B`` to a tolerance below the inner dtype's reach.

    Args:
      op: operator in its compute dtype (f32 — the hot path — or bf16 for
        the memory-lean mode; see outer_dtype).
      B: (n, k) right-hand sides (any float dtype; promoted to outer_dtype).
      tol: outer true-residual target.
      inner_tol: per-cycle inner solve target (1e-4..1e-6 sensible in f32;
        >= ~3e-3 in bf16, whose epsilon is ~8e-3 — each cycle then
        contracts the residual by ~2 digits).
      solve_fn: optional override ``(op, R32, tol) -> (D, info)`` — e.g. a
        distributed closure; defaults to solve_sbcgrq/solve_bcg.
      op64: optional full-precision operator for the outer residual. Default
        is ``op`` promoted to ``outer_dtype`` — exact for operators whose
        entries are representable there (stencil coefficients, lattice
        hoppings); pass the original operator when the matrix data itself
        was rounded down, otherwise the reachable tolerance floors at the
        rounding error.
      outer_dtype: dtype of the outer accumulator/true-residual loop.
        Default f64 (complex128 for complex B) — the 1e-10 north-star path.
        Pass ``jnp.float32`` for the memory-lean composition (bf16 inner
        fields + f32 outer): reaches ~1e-7 with about half the field
        memory (f64 outer fields alone are 3 x 8.6 GB at the full-size
        16.7M-row config 5).

    Returns:
      (X, SolverInfo) with X in ``outer_dtype``; ``info.iterations`` counts
      refinement cycles, ``info.matvecs`` totals inner + outer applications.
    """
    if solve_fn is None:
        if inner_solver == "sbcgrq":
            def solve_fn(o, r, t):
                return solve_sbcgrq(
                    o, r, tol=t, max_iter=inner_max_iter,
                    qr_passes=qr_passes, replace_every=replace_every,
                )
        elif inner_solver == "bcg":
            def solve_fn(o, r, t):
                return solve_bcg(o, r, tol=t, max_iter=inner_max_iter)
        else:
            raise ValueError(f"unknown inner solver {inner_solver!r}")

    import contextlib

    compute_dtype = op.dtype
    cplx = jnp.issubdtype(jnp.dtype(B.dtype), jnp.complexfloating)
    if outer_dtype is None:
        f64 = jnp.complex128 if cplx else jnp.float64
    else:
        f64 = jnp.dtype(outer_dtype)
    wide = jnp.dtype(f64).itemsize >= 8
    # The f64 outer residual genuinely needs the x64 flag; without it
    # jnp.float64 silently degrades to f32 and refinement
    # stalls at the f32 noise floor (~5e-7). The flag is scoped to the f64
    # pieces only — the hot inner solve traces outside it. A f32 outer
    # (outer_dtype=jnp.float32, the capacity mode) skips the scope.
    x64_scope = (lambda: jax.enable_x64(True)) if wide else (
        contextlib.nullcontext)
    with x64_scope():
        if op64 is None:
            op64 = op_astype(op, f64)
        B64 = B.astype(f64)
        bnorm = jnp.linalg.norm(B64, axis=0)
        bnorm = jnp.where(bnorm > 0, bnorm, 1.0)
        X = jnp.zeros_like(B64)
        if checkpoint_path is not None:  # resume = warm start (SURVEY.md §6)
            from blockcg.utils.checkpoint import load_checkpoint

            ckpt = load_checkpoint(checkpoint_path)
            if ckpt is not None:
                X = ckpt[0].astype(f64)
                if verbose:
                    print(f"[refine] resumed from {checkpoint_path} (cycle {ckpt[1]})")
        # Cycle 0 of the compiled outer program (D = 0): true residual,
        # per-RHS scaling (so the f32 inner solver sees O(1) columns —
        # residuals span decades across cycles), next inner RHS. One
        # dispatch; the scale/relres host round-trips of the former eager
        # version are gone.
        zero_d = jnp.zeros(B.shape, compute_dtype)
        ones = jnp.ones_like(bnorm)
        X, R_in, scale, relres = _refine_cycle(
            op64, X, zero_d, ones, B64, bnorm, jnp.dtype(compute_dtype)
        )
        already_done = bool(jnp.max(relres) <= tol)

    matvecs = 1
    cycles = 0
    if already_done:
        max_cycles = 0  # e.g. resumed from a converged checkpoint
    for cycles in range(1, max_cycles + 1):
        D, inner_info = solve_fn(op, R_in, inner_tol)
        matvecs += int(inner_info.matvecs)
        with x64_scope():
            X, R_in, scale, relres = _refine_cycle(
                op64, X, jnp.asarray(D), scale, B64, bnorm,
                jnp.dtype(compute_dtype),
            )
            # The f64 relres is reduced inside the scope: outside it, JAX
            # would truncate the reduction to f32.
            worst = float(jnp.max(relres))
        matvecs += 1
        if checkpoint_path is not None:
            from blockcg.utils.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, X, iteration=cycles)
        done = worst <= tol
        if verbose:
            print(f"[refine] cycle {cycles}: max relres = {worst:.3e}")
        if done:
            break

    with x64_scope():
        info = SolverInfo(
            iterations=jnp.int32(cycles),
            relres=relres,
            converged=relres <= tol,
            matvecs=jnp.int32(matvecs),
        )
    return X, info


# ------------------------------------------------- capacity (lean) driver --


@functools.partial(
    jax.jit,
    static_argnames=("k", "bdtype", "compute_dtype"),
    donate_argnums=(1, 2),
)
def _lean_cycle(op_out, Xt, Dt, scale, key, k, bdtype, compute_dtype):
    """One outer cycle of the memory-lean refinement. Everything
    lanes-major (k, n); B is REGENERATED on device from ``key``
    (deterministic — the problem's RHS is defined as these values) instead
    of living in device memory for the whole solve; Xt/Dt buffers are
    donated. Peak live set ~3 f32 fields + 2 bf16.

    ``op_out`` is the f32-WIDENED operator (bf16 entries lift exactly): the
    outer true residual must be measured through a pure-f32 apply, same as
    solve_refined's ``op_astype`` outer operator. Routing the f32 field
    through the bf16 operator would floor the on-device relres estimate at
    the bf16 epsilon (~1.7e-3) while the true residual is far lower."""
    Xt = Xt + Dt.astype(Xt.dtype) * scale[:, None]
    Zt = op_out.matmat_t(Xt)  # pure-f32 outer apply
    # Generate f32 and round: normal() DIRECTLY in bf16 is not bitwise
    # stable across the jit boundary (measured 6e-3 jit-vs-eager drift),
    # and B must be the same exact values every cycle and in every
    # verifier. f32 -> bdtype rounding is deterministic everywhere. B is
    # STORED in bdtype (2.1 GB at full size); its f32 lifts below are
    # elementwise and fuse into the reductions/subtractions — no f32 B or
    # R field is ever materialized, keeping the cycle's peak live set to
    # X + Z + B_bf16 + Rn_bf16 (~13 GB at full-size config 5).
    #
    # The optimization_barrier is LOAD-BEARING: XLA may ELIDE an in-jit
    # convert(convert(x, bf16), f32) round-trip, and the cycle would then
    # measure the residual against UNROUNDED B while eager verifiers round
    # properly — a relres floor of ||round_bf16(B)-B||/||B|| ~ 1.7e-3.
    Bt = jax.lax.optimization_barrier(
        jax.random.normal(key, Zt.shape, jnp.float32).astype(bdtype))

    def lift(a):
        return a.astype(Xt.dtype)

    bnorm = jnp.sqrt(jnp.sum(lift(Bt) * lift(Bt), axis=1))
    bnorm = jnp.where(bnorm > 0, bnorm, jnp.ones_like(bnorm))
    nrm = jnp.sqrt(jnp.sum((lift(Bt) - Zt) ** 2, axis=1))
    relres = nrm / bnorm
    sc = jnp.where(nrm > 0, nrm, jnp.ones_like(nrm))
    Rn = ((lift(Bt) - Zt) / sc[:, None]).astype(compute_dtype)
    return Xt, Rn, sc, relres


def solve_refined_lean(
    op,
    key,
    k: int,
    *,
    tol: float = 1e-6,
    inner_tol: float = 5e-3,
    max_cycles: int = 12,
    inner_max_iter: int = 2000,
    qr_passes: int = 1,
    inner_block: int | None = None,
    bdtype=jnp.bfloat16,
    deflate: bool = False,
    restart_overhead_s: float | None = None,
    verbose: bool = False,
):
    """Memory-lean iterative refinement for CAPACITY runs — the composition
    that fits a field block into about half the device memory of a plain
    f32 solve (BASELINE.json configs[4]):

    - RHS: ``B = normal(key, (k, n), bdtype)`` regenerated ON DEVICE each
      outer cycle — 0 bytes persistent (vs 4.3 GB f32 at full size).
    - Outer accumulator Xt: f32, lanes-major, donated through cycles.
    - Inner solves: the operator's compute dtype (bf16 fields, f32
      accumulation), on ``inner_block``-wide column slices so the inner live
      set stays bounded (default k//2 when k > 32).

    Returns (X (n, k) f32, SolverInfo). relres is measured against the f32
    lift of the generated B (bdtype=bf16 values are exact in f32)."""
    from blockcg.solvers.sbcgrq import _sbcgrq_impl

    n = op.n
    compute_dtype = op.dtype
    kb = inner_block or (k // 2 if k > 32 else k)
    if k % kb:
        raise ValueError(f"inner_block {kb} must divide k={k}")

    # Outer residual operator: exact f32 lift of the (possibly bf16) op —
    # +1 f32 diags copy (~0.44 GB at full-size config 5, in budget).
    op_out = op if jnp.dtype(compute_dtype) == jnp.float32 else (
        op_astype(op, jnp.float32))

    Xt = jnp.zeros((k, n), jnp.float32)
    Dt = jnp.zeros((k, n), compute_dtype)
    scale = jnp.ones((k,), jnp.float32)
    matvecs = 0
    cycles = 0
    relres = None
    prev_worst = float("inf")
    stagnant = 0
    for cycles in range(0, max_cycles + 1):
        Xt, Rn, scale, relres = _lean_cycle(
            op_out, Xt, Dt, scale, key, k, jnp.dtype(bdtype),
            jnp.dtype(compute_dtype),
        )
        matvecs += 1
        worst = float(jnp.max(relres))
        if verbose:
            print(f"[lean] cycle {cycles}: max relres = {worst:.3e}",
                  flush=True)
        if worst <= tol or cycles == max_cycles:
            break
        if worst >= 0.9 * prev_worst:
            # One slow cycle is normal (the kb-sliced inners alternate
            # slow/fast cycles); TWO consecutive mark a precision floor:
            # stop burning inner solves.
            stagnant += 1
            if stagnant >= 2:
                if verbose:
                    print(f"[lean] stagnated at {worst:.3e} (floor); "
                          f"stopping", flush=True)
                break
        else:
            stagnant = 0
        prev_worst = worst
        parts = []
        nsl = k // kb
        for jj in range(nsl):
            Bs = Rn[jj * kb : (jj + 1) * kb]
            if jj == nsl - 1:
                # Rn (a full (k, n) field — 2 GB at full-size config 5) is
                # dead once its last slice is extracted; dropping it before
                # the peak-liveness inner solve lowers the peak by a field.
                del Rn
            if deflate:
                # Converged-column deflation at capacity: the lanes-major
                # width-halving driver — no (n, k) transposes, so the lean
                # memory budget is unchanged up to the (w, n) stage
                # repacks.
                from blockcg.solvers.deflate import _deflated_driver

                def stage(Bss, X0s, budget, floor, tol_s):
                    if X0s is None:  # driver's narrow-width early path
                        X0s = jnp.zeros_like(Bss)
                    return _sbcgrq_impl(
                        op, Bss, X0s, tol_s, inner_max_iter,
                        qr_passes=qr_passes, replace_every=0,
                        axis_name=None, record_history=False,
                        active_floor=floor, iter_cap=budget,
                    )

                Dj, info_j = _deflated_driver(
                    stage, Bs, None, tol=inner_tol,
                    max_iter=inner_max_iter, min_width=8, width_quantum=8,
                    restart_overhead_s=restart_overhead_s, k_axis=0,
                )
            else:
                Dj, info_j = _sbcgrq_impl(
                    op, Bs, jnp.zeros((kb, n), compute_dtype),
                    inner_tol, inner_max_iter, qr_passes=qr_passes,
                    replace_every=0, axis_name=None, record_history=False,
                )
            del Bs
            matvecs += int(info_j.matvecs)
            parts.append(Dj)
        Dt = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    info = SolverInfo(
        iterations=jnp.int32(cycles),
        relres=relres,
        converged=relres <= tol,
        matvecs=jnp.int32(matvecs),
    )
    return Xt.T, info
