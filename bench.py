"""Operator and solver timings on one GPU — prints ONE JSON line.

Headline: SpMM nnz/s on north-star config 3 (3D 7-pt Laplacian 64^3, 262k
rows, k=32 RHS block) through the operator's public ``matmat_t``, beside a
plain-jnp copy that calibrates the card's achievable memory bandwidth in
the same run. Extra fields: the 1M-row streaming Laplacian apply, the
config-4 const-hop and matrix-link 32^4 lattice applies, the SBCGrQ
block-update chain per iteration at configs 3 and 5 against the
10-field-pass model (DESIGN.md §2), SBCGrQ time-to-tol at config 3, and
the 2.1M-row 1e-10 refined solve.

Every timing is host clock around work that ends in ``block_until_ready``;
chained applies run inside one jitted ``fori_loop`` and two loop lengths
are differenced, which cancels the per-dispatch overhead. The script
refuses to run without a GPU (chip_smoke.require_gpus): a CPU number is
never reported under a device metric.

Usage: python bench.py [--skip-config5]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from chip_smoke import card_identity, require_gpus


def _loop_seconds(compiled, args, trials: int) -> float:
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def time_chain(step, x0, lengths=(16, 80), trials=5, args=()):
    """Seconds per ``step`` call: a jitted fori_loop of N chained calls for
    two N, differenced (per-length minimum over ``trials``)."""
    compiled = {}
    for n in lengths:
        def loop(x, *a, n=n):
            return jax.lax.fori_loop(0, n, lambda i, u: step(u, *a), x)
        compiled[n] = jax.jit(loop).lower(x0, *args).compile()
    t = {n: _loop_seconds(compiled[n], (x0,) + tuple(args), trials)
         for n in lengths}
    n1, n2 = lengths
    return max((t[n2] - t[n1]) / (n2 - n1), t[n2] / n2 * 1e-3)


def measure_apply(op, Xt, **kw) -> float:
    """Seconds per operator apply (``matmat_t``) on the field ``Xt``.

    The loop carry is the apply's output, rescaled so values stay finite;
    the scale fuses into the apply, so the chain moves no extra field."""
    def step(u, o):
        y = o.matmat_t(u)
        return y * jnp.asarray(1e-1, y.dtype)
    return time_chain(step, Xt, args=(op,), **kw)


def calibrate_copy_bw(n: int = 1 << 26) -> float:
    """Achievable memory bandwidth (bytes/s): a chained f32 scale
    ``u -> 0.5 u`` of n elements, one read and one write per step."""
    u = jnp.ones((n,), jnp.float32)
    dt = time_chain(lambda v: v * jnp.float32(0.5), u)
    return 2 * 4 * n / dt


def measure_update_chain(op, k: int, seed: int = 0) -> float:
    """Seconds per SBCGrQ block-update chain, SpMM excluded: the V update
    with its Gram, the adaptive one-pass QR and the P/X tail, exactly as
    solvers/sbcgrq.py runs them. DESIGN.md §2 models this chain plus the
    P^H A P Gram at 10 field passes."""
    from blockcg.solvers.common import (
        f_gram, f_mm2_update_gram, f_px_update, kk_mm, qr_passes_from_gram,
    )

    rng = np.random.default_rng(seed)
    n = op.shape[0]

    def field():
        return op.to_internal(jnp.asarray(
            rng.standard_normal((k, n)), jnp.float32))

    W, Z, P, X = field(), field(), field(), field()
    eye = jnp.eye(k, dtype=jnp.float32)
    alpha = 1e-3 * jnp.asarray(rng.standard_normal((k, k)), jnp.float32)

    def step(carry, Z, alpha):
        W, P, X, Mqr = carry
        M = f_gram(P, Z, codec=op)
        Vt, G = f_mm2_update_gram(Mqr, W, -alpha - 1e-30 * M, Z, codec=op)
        Mqr2, Wt2, rho = qr_passes_from_gram(G, Vt, 1, codec=op)
        P, X = f_px_update(Mqr2, Wt2, rho, P, kk_mm(eye, alpha), X,
                           codec=op)
        return Wt2, P, X, Mqr2

    return time_chain(step, (W, P, X, eye), args=(Z, alpha), lengths=(4, 20),
                      trials=3)


def field_bytes(op, k: int) -> int:
    return 4 * k * op.shape[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-config5", action="store_true",
                    help="leave out the 16.7M-row update-chain timing")
    args = ap.parse_args()
    require_gpus(1)

    import blockcg as bc
    from blockcg.problems import (
        dirac_cbdia, dirac_gauged_matrix, laplacian_dia,
    )

    dev = jax.devices()[0]
    card = card_identity()
    rng = np.random.default_rng(0)
    bw = calibrate_copy_bw()

    # Config 3 SpMM: diagonals once + X once + Y once is the floor.
    op = laplacian_dia((64, 64, 64), dtype=jnp.float32)
    k = 32
    Xt = jnp.asarray(rng.standard_normal((k, op.n)), jnp.float32)
    dt = measure_apply(op, Xt)
    dia_bytes = 4 * (len(op.offsets) * op.n + 2 * k * op.n)

    # Streaming regime: 1,048,576-row 3D Laplacian, k=32.
    op_s = laplacian_dia((128, 128, 64), dtype=jnp.float32)
    Xs = jnp.asarray(rng.standard_normal((k, op_s.n)), jnp.float32)
    dt_s = measure_apply(op_s, Xs)
    bytes_s = 4 * (len(op_s.offsets) * op_s.n + 2 * k * op_s.n)

    # Config 4 const-hop apply (masks stream; hops are compile-time).
    op4 = dirac_cbdia(32, m=0.5, dtype=jnp.float32)
    X4 = op4.to_internal(jnp.asarray(
        rng.standard_normal((12, op4.n)), jnp.float32))
    dt4 = measure_apply(op4, X4)
    nmask4 = 0 if op4.masks is None else op4.masks.shape[0]
    bytes4 = 2 * field_bytes(op4, 12) + 4 * nmask4 * op4.ns

    # Matrix-link 32^4: per-site 4x4 blocks stream with the field.
    opm = dirac_gauged_matrix(32, m=0.5, dtype=jnp.float32)
    Xm = opm.to_internal(jnp.asarray(
        np.random.default_rng(1234).standard_normal((12, opm.n)),
        jnp.float32))
    dt_m = measure_apply(opm, Xm)
    bytes_m = 2 * field_bytes(opm, 12) + 4 * opm.blocks.size

    # Update chain per iteration at config 3 (and config 5).
    chain3 = measure_update_chain(op, 32)
    chain = {"chain3_ms": chain3 * 1e3,
             "chain3_pass_equiv": chain3 * bw / field_bytes(op, 32)}
    if not args.skip_config5:
        op5 = laplacian_dia((256, 256, 256), dtype=jnp.float32)
        chain5 = measure_update_chain(op5, 64)
        chain.update(chain5_ms=chain5 * 1e3,
                     chain5_pass_equiv=chain5 * bw / field_bytes(op5, 64))
        del op5

    # SBCGrQ time-to-tol at config 3 (32 RHS, tol 1e-6).
    B = jnp.asarray(rng.standard_normal((op.n, 32)), jnp.float32)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=300)
    jax.block_until_ready(X)
    solve_s = float("inf")
    for t in range(3):
        t0 = time.perf_counter()
        X, info = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=300)
        jax.block_until_ready(X)
        solve_s = min(solve_s, time.perf_counter() - t0)
    iters = int(info.iterations)

    # North-star: 1e-10 on a 2.1M-row 3D Laplacian, 32 RHS, f64 outer step.
    op_ns = laplacian_dia((128, 128, 128), dtype=jnp.float32)
    B_ns = jnp.asarray(np.random.default_rng(5678).standard_normal(
        (op_ns.n, 32)), jnp.float32)
    ns_kw = dict(tol=1e-10, inner_tol=3e-6, qr_passes=1)
    X_ns, info_ns = bc.solve_refined(op_ns, B_ns, **ns_kw)
    jax.block_until_ready(X_ns)
    ns_s = float("inf")
    for t in range(2):
        t0 = time.perf_counter()
        X_ns, info_ns = bc.solve_refined(op_ns, B_ns, **ns_kw)
        jax.block_until_ready(X_ns)
        ns_s = min(ns_s, time.perf_counter() - t0)

    print(json.dumps({
        "metric": "SpMM nnz/s (config 3: 3D Laplacian 64^3, k=32, "
                  "DIA matmat_t)",
        "value": op.nnz / dt / 1e9,
        "unit": "Gnnz/s",
        "copy_bw_gbs": bw / 1e9,
        "spmm_ms": dt * 1e3,
        "spmm_frac_of_copy_bw": dia_bytes / dt / bw,
        "streaming_gnnzs": op_s.nnz / dt_s / 1e9,
        "streaming_ms": dt_s * 1e3,
        "streaming_frac_of_copy_bw": bytes_s / dt_s / bw,
        "dirac32_cbdia_ms": dt4 * 1e3,
        "dirac32_cbdia_frac_of_copy_bw": bytes4 / dt4 / bw,
        "matrix_link32_ms": dt_m * 1e3,
        "matrix_link32_frac_of_copy_bw": bytes_m / dt_m / bw,
        **chain,
        "sbcgrq_time_to_tol_s": solve_s,
        "sbcgrq_iters": iters,
        "sbcgrq_ms_per_iter": solve_s / max(iters, 1) * 1e3,
        "northstar_1e10_s": ns_s,
        "northstar_iters": int(info_ns.iterations),
        "northstar_monitor_relres": float(jnp.max(info_ns.relres)),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
