#!/usr/bin/env python
"""Bench CLI (T-B1) — run north-star preset configs and emit JSON lines.

Usage:
  python bench_cli.py --config cg_2d_128            # one preset
  python bench_cli.py --config all --scale 0.5      # every preset, shrunk
  python bench_cli.py --config sbcgrq_3d_64 --tol 1e-10 --refined
  python bench_cli.py --list

Each run prints one JSON line (SolveRecord schema, utils/metrics.py) and
appends it to --out when given. Config 5 (16.7M rows, k=64) at full size
needs about 30 GB of device memory in plain f32 — use --scale on smaller
devices, or run it through parallel.solve_sbcgrq_dist on several.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _scaled_preset(name: str, scale: float, dtype):
    import jax.numpy as jnp

    from blockcg.problems import laplacian_dia, dirac_cbdia

    def rhs(n, k, seed=42):
        rng = np.random.default_rng(seed)
        return jnp.asarray(rng.standard_normal((n, k)), dtype=dtype)

    def dim(d, lo=8):
        return max(lo, int(round(d * scale)) // 4 * 4)

    if name == "cg_2d_128":
        op = laplacian_dia((dim(128), dim(128)), dtype=dtype)
        return op, rhs(op.n, 4), "cg"
    if name == "bcg_2d_512":
        op = laplacian_dia((dim(512), dim(512)), dtype=dtype)
        return op, rhs(op.n, 16), "bcg"
    if name == "sbcgrq_3d_64":
        op = laplacian_dia((dim(64),) * 3, dtype=dtype)
        return op, rhs(op.n, 32), "sbcgrq"
    if name == "dirac_32":
        op = dirac_cbdia(dim(32, lo=4), m=0.5, dtype=dtype)
        return op, rhs(op.n, 12), "sbcgrq"
    if name == "sbcgrq_3d_256":
        op = laplacian_dia((dim(256),) * 3, dtype=dtype)
        return op, rhs(op.n, 64), "sbcgrq"
    raise SystemExit(f"unknown config {name!r}")


NAMES = ["cg_2d_128", "bcg_2d_512", "sbcgrq_3d_64", "dirac_32", "sbcgrq_3d_256"]


def run_one(name: str, args) -> dict:
    import jax.numpy as jnp

    import blockcg as bc
    from blockcg.utils import timed_solve, log_jsonl

    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[args.dtype]
    op, B, solver = _scaled_preset(name, args.scale, dtype)
    if args.solver:
        solver = args.solver

    if args.refined:
        # bf16 inner tolerances floor near bf16 epsilon; pair the bf16
        # field mode with a matching inner_tol unless the user set one.
        inner_tol = args.inner_tol
        if args.dtype == "bf16" and inner_tol < 3e-3:
            inner_tol = 5e-3
        X, info, rec = timed_solve(
            f"refined-{solver}", bc.solve_refined, op, B.astype(jnp.float32),
            tol=args.tol, inner_tol=inner_tol, inner_solver=solver
            if solver in ("sbcgrq", "bcg") else "sbcgrq",
        )
    elif solver == "cg":
        X, info, rec = timed_solve(
            "cg", bc.solve_cg, op, B[:, 0], tol=args.tol, max_iter=args.max_iter
        )
    elif solver == "bcg":
        X, info, rec = timed_solve(
            "bcg", bc.solve_bcg, op, B, tol=args.tol, max_iter=args.max_iter
        )
    else:
        X, info, rec = timed_solve(
            "sbcgrq", bc.solve_sbcgrq, op, B, tol=args.tol,
            max_iter=args.max_iter, replace_every=args.replace_every,
        )
    rec.extra["config"] = name
    rec.extra["scale"] = args.scale
    rec.extra["dtype"] = args.dtype
    if args.scale < 1.0:
        # Shrunk presets are dominated by fixed per-solve costs — they
        # regression-test correctness/compilation, not throughput. Perf
        # rows must come from scale 1.0 runs.
        rec.extra["smoke_only"] = True
    print(rec.to_json())
    if args.out:
        log_jsonl(args.out, rec)
    return json.loads(rec.to_json())


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="all", help="|".join(NAMES) + "|all")
    ap.add_argument("--solver", default=None, choices=[None, "cg", "bcg", "sbcgrq"])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--inner-tol", type=float, default=1e-5)
    ap.add_argument("--max-iter", type=int, default=2000)
    ap.add_argument("--replace-every", type=int, default=0)
    ap.add_argument("--refined", action="store_true", help="refine to tol < f32")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="field/operator storage dtype (bf16 = capacity "
                    "mode, f32 in-kernel accumulation; pair with --refined "
                    "for sub-bf16 tolerances)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        print("\n".join(NAMES))
        return
    names = NAMES if args.config == "all" else [args.config]
    ok = True
    for name in names:
        try:
            rec = run_one(name, args)
            ok &= rec.get("converged", False)
        except Exception as e:  # keep sweeping the other configs
            print(json.dumps({"config": name, "error": repr(e)}))
            ok = False
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
