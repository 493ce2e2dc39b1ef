"""SBCGrQ — thin-QR-stabilized block CG (T-S3, the flagship solver).

Reference equivalent: R7 (SURVEY.md §3.1); recurrence per SURVEY.md §1.2
(Dubrulle BIT 41 (2001) "rQ" stabilization, numerically validated there):

    [Q, S] = thinQR(B - A X0);  P = Q
    loop:
        Z   = A P                          # the hot SpMM
        a   = (P^T Z)^{-1}                 # k x k Cholesky inverse
        X  += P (a S)
        [Q, r] = thinQR(Q - Z a)           # re-orthonormalize the residual
        S   = r S                          # true residual R = Q S throughout
        P   = Q + P r^T
        # per-RHS monitor: ||R e_j|| = ||S e_j|| (Q orthonormal)

Invariant (unit-tested): ``B - A X == Q S`` at every iteration. Convergence
monitoring (T-C4) is free: per-RHS residual norms are the column norms of the
k x k ``S`` because Q has orthonormal columns — no (n,k) reduction needed.

Pass-count structure: Q is never materialized.
The residual basis is carried as the pair ``(M_qr, W)`` with ``Q = M_qr @ W``
(M_qr the deferred CholQR transform, k x k), so per iteration the field
traffic is

    SpMM (read P, write Z) + Gram P^H Z                     2 passes + A
    V = M_qr W - alpha Z, Gram V V^H                        3 passes
    P' = M_qr' V + rho^H P ;  X' = X + (alpha S)^T-style P  5 passes

= 10 field passes at qr_passes=1 when XLA fuses each line (vs 13 with an
explicit Q and
CholeskyQR2). Transposed lanes-major forms as before (alpha^T = conj(alpha),
rho^{H,T} = conj(rho)).

The thin QR is distributed CholeskyQR (T-C3): the only cross-device traffic
per iteration is one halo exchange inside ``op`` plus two k x k psums
(SURVEY.md §4.3).

Residual replacement (T-C5): every ``replace_every`` iterations — or
adaptively, whenever the equilibrated QR Gram's condition estimate
``kappa_1(G1)`` exceeds ``replace_kappa`` — the true residual is recomputed
with one extra SpMM and Q/S are refreshed. Two semantics (``replace_mode``):

- ``"restart"`` (default): P is reset to the fresh Q — a full restart of
  the block recurrence. Robust in every dtype; costs Krylov momentum when
  replacements are frequent (measured: config-3 replace_every=25 inflates
  iterations 103 -> 333), so pair it with sparse schedules.
- ``"rebase"``: P is KEPT and the fresh factorization is re-expressed in
  the old Q basis via the unitary U = S Sn^{-1} folded into the deferred
  Mqr transform (``common.residual_rebase``) — zero extra field passes and
  zero iteration inflation. Exact in f64 (measured: replace_every=1 matches
  the unreplaced iteration count). NOT safe in f32: once columns converge
  below ~sqrt(eps), the drift between S and Sn is O(1) relative in those
  columns and the triangular solve amplifies it (measured divergence at
  replace_every<=10). Use for f64 solves; f32 deep solves should go through
  solvers/refine.py instead.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from blockcg.types import SolverInfo
from blockcg.solvers.common import (
    chol_inverse_spd,
    f_gram,
    f_matmat_gram,
    f_mm2_update_gram,
    f_mm_update,
    f_px_update,
    kk_mm,
    qr_passes_from_gram,
    residual_rebase,
    row_norms2_t,
)


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter",
        "qr_passes",
        "replace_every",
        "axis_name",
        "record_history",
        "replace_kappa",
        "replace_mode",
    ),
)
def _sbcgrq_impl(
    op, Bt, X0t, tol, max_iter, qr_passes, replace_every, axis_name,
    record_history, active_floor=0, replace_kappa=0.0,
    replace_mode="restart", iter_cap=None,
):
    from blockcg.solvers.common import acc_dtype

    # Scalar/k x k solver algebra lives in the accumulation dtype: bf16
    # FIELDS (the capacity mode) still monitor/factorize in f32.
    rdtype = acc_dtype(jnp.real(Bt).dtype)
    bnorm = jnp.sqrt(row_norms2_t(Bt, axis_name, codec=op))
    bnorm = jnp.where(bnorm > 0, bnorm, jnp.asarray(1.0, rdtype))
    # tol may be a scalar or a per-RHS (k,) vector (deflation stages solve
    # correction systems whose targets differ per column, solvers/deflate.py).
    tol_arr = jnp.asarray(tol, rdtype)
    floor = jnp.asarray(active_floor, jnp.int32)
    # iter_cap is a TRACED cap <= the static max_iter (which sizes the
    # history ring and stays in the jit cache key): deflation stages pass
    # their shrinking budget here so every stage shares ONE compilation —
    # a per-stage static budget would recompile the whole solver each
    # restart.
    cap = (jnp.int32(max_iter) if iter_cap is None
           else jnp.minimum(jnp.asarray(iter_cap, jnp.int32),
                            jnp.int32(max_iter)))

    def fresh_qs(Xt):
        """True residual, re-factorized in DEFERRED form (Q = Mi @ W never
        materialized): one extra SpMM + Gram + thin-QR factors. The last
        element is the k x k-side orthogonality error (breakdown detector:
        numerically rank-deficient blocks that no CholeskyQR pass count
        can repair — see SolverInfo.breakdown)."""
        Rt = Bt - op.matmat_t(Xt)
        G = f_gram(Rt, Rt, axis_name, codec=op)
        return qr_passes_from_gram(G, Rt, qr_passes, axis_name, codec=op,
                                   want_ortho=True)

    Mi0, W0t, S0, orth0 = fresh_qs(X0t)
    k = S0.shape[0]
    # P0 = Q0 — the one place Q is materialized (init only).
    Q0t = f_mm_update(Mi0, W0t, codec=op)
    hist0 = jnp.full((max_iter,), jnp.nan, rdtype) if record_history else None

    def relres_of(S):
        # R = Q S with orthonormal Q: per-RHS residual norm = ||S e_j||.
        return jnp.sqrt(jnp.sum(jnp.real(S * jnp.conj(S)), axis=0)) / bnorm

    def cond(state):
        _, _, _, S, _, it, _, _, _, _ = state
        # Continue while more than ``active_floor`` RHS are unconverged:
        # floor 0 is the plain stop rule; a deflation outer loop sets the
        # floor to the next stage's width so this stage hands over as soon
        # as the block is half-idle (T-C4 deflation, solvers/deflate.py).
        n_active = jnp.sum((relres_of(S) > tol_arr).astype(jnp.int32))
        return jnp.logical_and(it < cap, n_active > floor)

    def body(state):
        Xt, Wt, Mqr, S, Pt, it, mv, hist, per_rhs, orth = state
        per_rhs = per_rhs + (relres_of(S) > tol_arr).astype(jnp.int32)
        # SpMM with the P^H A P Gram (operators/base.py matmat_gram_t).
        Zt, M = f_matmat_gram(op, Pt, axis_name)
        alpha = chol_inverse_spd(M)  # Hermitian
        # Lanes-major transposed recurrence: the column-world update
        # V = Q - Z alpha transposes to Vt = Qt - alpha^T Zt with
        # alpha^T = conj(alpha) (Hermitian inverse; no-op when real), and
        # Qt = Mqr @ Wt is applied on the fly — Q is never materialized.
        # The V update also emits V V^H, whose diagonal carries the CholQR
        # equilibration norms: the QR needs no extra field passes.
        alpha_t = jnp.conj(alpha)
        Vt, G = f_mm2_update_gram(Mqr, Wt, -alpha_t, Zt, axis_name, codec=op)
        Mqr2, Wt2, rho, cond1, oe = qr_passes_from_gram(
            G, Vt, qr_passes, axis_name, codec=op, want_cond=True,
            want_ortho=True,
        )
        orth = jnp.maximum(orth, oe)
        # Tail (5 passes): P' = Mqr2 Wt2 + conj(rho) P and
        # X' = X + (S^T alpha^T) P — both read the PRE-update P.
        Pt, Xt = f_px_update(
            Mqr2, Wt2, jnp.conj(rho), Pt, kk_mm(S.T, alpha_t), Xt, codec=op,
        )
        S = kk_mm(rho, S)
        mv = mv + 1

        if replace_every > 0 or replace_kappa > 0:
            if replace_mode == "rebase":
                def replace(args):
                    Xt, _, _, S, Pt, mv, orth = args
                    # Fresh true-residual factorization, re-expressed in the
                    # OLD Q basis via the unitary U = S Sn^{-1} folded into
                    # the deferred Mqr transform (zero extra field passes):
                    # keeps the Krylov momentum (P untouched) AND the
                    # P^T Q = I invariant. f64-only — see module docstring.
                    Min, Wnt, Sn, oe2 = fresh_qs(Xt)
                    U = residual_rebase(S, Sn)
                    return (Xt, Wnt, kk_mm(jnp.conj(U), Min), kk_mm(U, Sn),
                            Pt, mv + 1, jnp.maximum(orth, oe2))
            else:
                def replace(args):
                    Xt, _, _, _, _, mv, orth = args
                    # Full restart: fresh factorization, P reset to the new
                    # Q (materialized once — replacements are sparse).
                    Min, Wnt, Sn, oe2 = fresh_qs(Xt)
                    Qn = f_mm_update(Min, Wnt, codec=op)
                    return (Xt, Wnt, Min, Sn, Qn, mv + 1,
                            jnp.maximum(orth, oe2))

            do = jnp.asarray(False)
            if replace_every > 0:
                do = (it + 1) % replace_every == 0
            if replace_kappa > 0:
                do = do | (cond1 > jnp.asarray(replace_kappa, cond1.dtype))
            Xt, Wt2, Mqr2, S, Pt, mv, orth = lax.cond(
                do, replace, lambda a: a, (Xt, Wt2, Mqr2, S, Pt, mv, orth)
            )

        if hist is not None:
            hist = hist.at[it].set(jnp.max(relres_of(S)))
        return (Xt, Wt2, Mqr2, S, Pt, it + 1, mv, hist, per_rhs, orth)

    state0 = (X0t, W0t, Mi0, S0, Q0t, jnp.int32(0), jnp.int32(1), hist0,
              jnp.zeros((k,), jnp.int32), orth0)
    Xt, Wt, Mqr, S, Pt, it, mv, hist, per_rhs, orth = lax.while_loop(
        cond, body, state0
    )
    relres = relres_of(S)
    info = SolverInfo(
        iterations=it,
        relres=relres,
        converged=relres <= tol_arr,
        matvecs=mv,
        history=hist,
        per_rhs_iters=per_rhs,
        # >1% achieved-orthogonality error at some thin QR: the block was
        # numerically rank-deficient beyond repair (see SolverInfo docs).
        breakdown=orth > jnp.asarray(0.01, orth.dtype),
    )
    return Xt, info


def solve_sbcgrq(
    op: Any,
    B: jax.Array,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 1,
    replace_every: int = 0,
    axis_name: str | None = None,
    record_history: bool = False,
    active_floor: int = 0,
    replace_kappa: float = 0.0,
    replace_mode: str = "restart",
    iter_cap=None,
) -> tuple[jax.Array, SolverInfo]:
    """Solve ``A X = B`` (A SPD, B (n, k)) by stabilized block CG (SBCGrQ).

    ``tol`` may be a scalar or a per-RHS (k,) vector. ``active_floor`` > 0
    makes the loop hand over once at most that many RHS remain unconverged
    (the deflation outer loop's stage-exit rule, solvers/deflate.py).
    ``iter_cap`` is a TRACED iteration budget <= ``max_iter`` — changing it
    does not recompile (``max_iter`` is static: it sizes the history ring);
    the deflation driver threads its shrinking per-stage budget here.

    ``qr_passes`` defaults to 1: one CholeskyQR field pass per iteration
    with a k x k Gram-side refinement, escalating to a real second pass
    under ``lax.cond`` only when the Gram's condition estimate crosses
    1/(2 sqrt(eps)) — rank-deficient or near-converged blocks
    (common.qr_passes_from_gram). This is self-stabilizing; residual
    replacement (``replace_every`` > 0 or the kappa trigger
    ``replace_kappa`` > 0) additionally re-anchors the residual
    factorization to the true residual. ``replace_mode`` picks the
    replacement semantics: "restart" (robust, resets P) or "rebase"
    (keeps P; f64 only — see module docstring).
    """
    if B.ndim == 1:
        raise ValueError("solve_sbcgrq expects an (n, k) block; use solve_cg for k=1")
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    if replace_mode not in ("restart", "rebase"):
        raise ValueError("replace_mode must be 'restart' or 'rebase'")
    # Solver state lives in the operator's internal field view (e.g.
    # (k, bs, ns) for block operators) — converted once here, not per apply.
    Bt = op.to_internal(B.T)
    X0t = jnp.zeros_like(Bt) if X0 is None else op.to_internal(X0.T)
    Xt, info = _sbcgrq_impl(
        op, Bt, X0t, tol, max_iter, qr_passes, replace_every, axis_name,
        record_history, active_floor, replace_kappa=float(replace_kappa),
        replace_mode=replace_mode, iter_cap=iter_cap,
    )
    return op.from_internal(Xt).T, info
