#!/usr/bin/env python
"""On-GPU smoke test of the block-CG solver stack, through its public API.

    python chip_smoke.py                # one GPU: phases 1-7 below
    python chip_smoke.py --four-cards   # four GPUs: the row-partitioned
                                        # config-5 solve vs one card

Phases (one process, so one JAX client owns the card):
  1. device check: the default device must be a GPU (no CPU fallback);
     prints the device kind and count and nvidia-smi's name and power limit
  2. config 3: 3D Laplacian 64^3 (262k rows), k=32, solve_sbcgrq, tol 1e-6
  3. config 4: const-hop Dirac-like 32^4 (4.2M rows), k=12; one apply vs
     scipy float64 (relative error <= 1e-5 rules out TF32 products), then
     solve_sbcgrq, tol 1e-6
  4. north-star: 3D Laplacian 128^3 (2.1M rows), k=32, solve_refined to
     1e-10 with a float64 outer residual
  5. config 5: 3D Laplacian 256^3 (16.7M rows), k=64, plain f32
     solve_sbcgrq, tol 1e-6, with the compiled solve's memory analysis
  6. complex Hermitian: U(1)-gauged Dirac-like 16^4 in complex64, k=12,
     buffers checked to live on the GPU
  7. the tests marked ``gpu``, run in this process by pytest

Every solve is checked by its TRUE relative residual ||B - AX|| / ||B||,
recomputed in float64 by scipy from the problem's own matrix (the f32
monitor can understate it). Each phase prints one ``PHASE`` line with its
iterations, warm wall time, true relres and tolerance, and device bytes,
beside the card name and power limit. Any failed check exits non-zero. The
last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class PhaseFailure(RuntimeError):
    """A phase's result did not meet its check."""


def card_identity() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _bytes(dev) -> dict:
    stats = dev.memory_stats()
    if not stats:
        return {"peak_bytes_in_use": None, "bytes_in_use": None}
    return {"peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_in_use": stats.get("bytes_in_use")}


def true_relres(a, X, B, cols=None) -> np.ndarray:
    """Per-column ||B - a X|| / ||B|| in float64 (``a`` a scipy matrix)."""
    X = np.asarray(X)
    B = np.asarray(B)
    if cols is not None:
        X, B = X[:, cols], B[:, cols]
    wide = np.complex128 if np.iscomplexobj(X) or np.iscomplexobj(B) \
        else np.float64
    X, B = X.astype(wide), B.astype(wide)
    return np.linalg.norm(B - a @ X, axis=0) / np.linalg.norm(B, axis=0)


def _check(name: str, relres: np.ndarray, limit: float) -> float:
    worst = float(np.max(relres))
    if not np.all(np.isfinite(relres)) or worst > limit:
        raise PhaseFailure(f"{name}: true relres {worst:.3e} > {limit:.0e}")
    return worst


def _timed(fn):
    """(result, warm seconds): one call to compile and warm, one timed."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _record(name, info, warm_s, relres, limit, dev, card, **extra) -> dict:
    rec = {"phase": name, "iterations": int(info.iterations),
           "warm_s": warm_s, "true_relres": relres, "tolerance": limit,
           **_bytes(dev), "card": card, **extra}
    print("PHASE " + json.dumps(rec), flush=True)
    return rec


def phase_config3(card: str, shape=(64, 64, 64)) -> dict:
    import jax
    import blockcg as bc
    from blockcg.problems import laplacian_scipy, presets

    op, B, _ = presets.config3_sbcgrq_3d_64(shape=shape)
    (X, info), warm_s = _timed(
        lambda: bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=1000))
    rr = _check("config3", true_relres(laplacian_scipy(shape), X, B), 1e-5)
    return _record("config3", info, warm_s, rr, 1e-5, jax.devices()[0], card,
                   rows=op.n, k=B.shape[1])


def phase_config4(card: str, L: int = 32) -> dict:
    import jax
    import jax.numpy as jnp
    import blockcg as bc
    from blockcg.problems import bdia_scipy, presets

    op, B, _ = presets.config4_dirac_32(L=L)
    # The float64 scipy form in spin-major row order, as the operator's.
    a = bdia_scipy(op.to_block_dia())
    Bn = np.asarray(B, np.float64)
    Y = np.asarray(op.matmat(B), np.float64)
    want = a @ Bn
    apply_err = float(np.abs(Y - want).max() / np.abs(want).max())
    if apply_err > 1e-5:
        raise PhaseFailure(f"config4: apply relative error {apply_err:.3e} "
                           "> 1e-5 (a product ran below f32 precision)")
    (X, info), warm_s = _timed(
        lambda: bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=1000))
    rr = _check("config4", true_relres(a, X, B), 1e-5)
    del a
    return _record("config4", info, warm_s, rr, 1e-5, jax.devices()[0], card,
                   rows=op.n, k=B.shape[1], apply_rel_err=apply_err,
                   dtype=str(jnp.dtype(op.dtype)))


def phase_northstar(card: str, shape=(128, 128, 128), k: int = 32) -> dict:
    import jax
    import jax.numpy as jnp
    import blockcg as bc
    from blockcg.problems import laplacian_dia, laplacian_scipy

    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(np.random.default_rng(5678).standard_normal((op.n, k)),
                    jnp.float32)
    (X, info), warm_s = _timed(
        lambda: bc.solve_refined(op, B, tol=1e-10, inner_tol=3e-6,
                                 qr_passes=1))
    if np.asarray(X).dtype != np.float64:
        raise PhaseFailure(f"northstar: outer X is {np.asarray(X).dtype}, "
                           "not float64")
    rr = _check("northstar", true_relres(laplacian_scipy(shape), X, B),
                1e-10)
    return _record("northstar", info, warm_s, rr, 1e-10, jax.devices()[0],
                   card, rows=op.n, k=k, matvecs=int(info.matvecs))


def _config5(shape):
    from blockcg.problems import presets

    return presets.config5_sbcgrq_3d_256(shape=shape)


def _config5_cols(k: int) -> list[int]:
    return [0, k // 3, 2 * k // 3, k - 1]


def phase_config5(card: str, shape=(256, 256, 256)) -> dict:
    import jax
    import jax.numpy as jnp
    import blockcg as bc
    from blockcg.problems import laplacian_scipy
    from blockcg.solvers.sbcgrq import _sbcgrq_impl

    op, B, _ = _config5(shape)
    k = B.shape[1]
    tol, max_iter = 1e-6, 4000
    # The same program solve_sbcgrq runs, lowered from shapes only.
    field = jax.ShapeDtypeStruct((k, op.n), jnp.float32)
    compiled = _sbcgrq_impl.lower(
        op, field, field, tol, max_iter, 1, 0, None, False, 0,
        replace_kappa=0.0, replace_mode="restart", iter_cap=None).compile()
    mem = compiled.memory_analysis()
    print(f"config5 memory_analysis: {mem}", flush=True)
    (X, info), warm_s = _timed(
        lambda: bc.solve_sbcgrq(op, B, tol=tol, max_iter=max_iter))
    cols = _config5_cols(k)
    rr = _check("config5", true_relres(laplacian_scipy(shape), X, B, cols),
                1e-5)
    return _record("config5", info, warm_s, rr, 1e-5, jax.devices()[0], card,
                   rows=op.n, k=k, checked_cols=cols,
                   temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                   argument_bytes=getattr(mem, "argument_size_in_bytes",
                                          None))


def phase_complex(card: str, L: int = 16, k: int = 12) -> dict:
    import jax
    import jax.numpy as jnp
    import blockcg as bc
    from blockcg.problems import bdia_scipy, dirac_gauged

    dev = jax.devices()[0]
    op = dirac_gauged(L, dtype=jnp.complex64)
    rng = np.random.default_rng(21)
    B = jnp.asarray(rng.standard_normal((op.n, k))
                    + 1j * rng.standard_normal((op.n, k)), jnp.complex64)
    (X, info), warm_s = _timed(
        lambda: bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=1000))
    for what, arr in (("operator", op.blocks), ("solution", X)):
        if arr.devices() != {dev} or arr.dtype != jnp.complex64:
            raise PhaseFailure(f"complex: {what} is {arr.dtype} on "
                               f"{arr.devices()}, not complex64 on {dev}")
    rr = _check("complex", true_relres(bdia_scipy(op), X, B), 1e-5)
    return _record("complex", info, warm_s, rr, 1e-5, dev, card,
                   rows=op.n, k=k, dtype="complex64")


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise PhaseFailure(f"gpu-marked tests: pytest exit code {int(rc)}")


def phase_four_cards(card: str, shape=(256, 256, 256), D: int = 4) -> dict:
    """Config 5 row-partitioned over D devices vs the one-device solve."""
    import jax
    import blockcg as bc
    from blockcg.parallel import partition_dia, row_mesh, solve_sbcgrq_dist
    from blockcg.problems import laplacian_scipy

    op, B, _ = _config5(shape)
    k = B.shape[1]
    tol, max_iter = 1e-6, 4000
    mesh = row_mesh(D)
    dop = partition_dia(op, D)
    (Xd, info_d), warm_d = _timed(
        lambda: solve_sbcgrq_dist(dop, B, mesh, tol=tol, max_iter=max_iter))
    Xd = np.asarray(Xd)
    (Xs, info_s), warm_s = _timed(
        lambda: bc.solve_sbcgrq(op, B, tol=tol, max_iter=max_iter))
    Xs = np.asarray(Xs)
    a = laplacian_scipy(shape)
    cols = _config5_cols(k)
    rr_d = _check("four_cards(dist)", true_relres(a, Xd, B, cols), 1e-5)
    rr_s = _check("four_cards(single)", true_relres(a, Xs, B, cols), 1e-5)
    di = abs(int(info_d.iterations) - int(info_s.iterations))
    if di > 2:
        raise PhaseFailure(f"four_cards: iterations differ by {di} > 2")
    return _record("four_cards", info_d, warm_d, rr_d, 1e-5,
                   jax.devices()[0], card, rows=op.n, k=k, devices=D,
                   checked_cols=cols, single_iterations=int(info_s.iterations),
                   single_warm_s=warm_s, single_true_relres=rr_s)


def require_gpus(count: int):
    """The devices, or exit non-zero when JAX finds no GPU (or too few)."""
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        sys.exit(f"no GPU found: {e}")
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU found: the default device is {devs[0].platform!r}")
    if len(devs) < count:
        sys.exit(f"needs {count} GPUs, JAX sees {len(devs)}")
    return devs[:count]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-partitioned config-5 solve on "
                         "four GPUs, compared with the one-GPU solve")
    args = ap.parse_args(argv)

    import jax

    count = 4 if args.four_cards else 1
    devs = require_gpus(count)  # the card or nothing: no CPU fallback
    # Phase 7 runs the tests in this process: tell their conftest that JAX
    # is on the GPU (the backend is already up, so JAX itself ignores it).
    os.environ["JAX_PLATFORMS"] = "cuda"
    card = card_identity()
    print(f"device: {devs[0].device_kind} x {len(jax.devices())} "
          f"(JAX platform {devs[0].platform})", flush=True)
    print(f"card: {card}", flush=True)

    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_config3(card)
        phase_config4(card)
        phase_northstar(card)
        phase_config5(card)
        phase_complex(card)
        phase_gpu_tests()

    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
