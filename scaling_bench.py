#!/usr/bin/env python
"""Weak-scaling benchmark of the row-partitioned solve.

Row-partitioned SBCGrQ on a 3D Laplacian whose row count grows with the
device count (constant work per device), timed per iteration. One process
drives every local device (e.g. the four GPUs of one host, joined all to
all by NVLink); for several hosts, launch one process per host with
``--distributed`` and the coordinator arguments, and the SAME code runs
SPMD over all devices — the solver code is device-count agnostic (SURVEY.md
§8 hard part 5).

Per iteration each device sends 2 halos (k x bw x 4 B) and three k x k
psums — independent of n/D, so weak scaling is communication-bound only
when the halo time exceeds the overlappable interior SpMM time. The
sharded program is also validated against the single-device solve on a
fake CPU mesh (tests/test_distributed.py, tests/test_dist_cbdia.py).

Usage:
  python scaling_bench.py                  # single process, all local devices
  python scaling_bench.py --devices 4
  python scaling_bench.py --distributed --coordinator localhost:1234 \
      --num-processes 2 --process-id $ID    # one per host
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, default=None,
                    help="limit local device count (default: all)")
    ap.add_argument("--base-shape", type=int, nargs=3, default=(64, 64, 64),
                    help="per-device 3D Laplacian block (z grows with D)")
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--iters", type=int, default=300,
                    help="fixed iteration count (long enough that the fixed "
                         "per-call dispatch cost is negligible)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    import jax

    if args.distributed:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import jax.numpy as jnp

    from blockcg.parallel import partition_dia, row_mesh, solve_sbcgrq_dist
    from blockcg.problems import laplacian_dia

    ndev = args.devices or len(jax.devices())
    if ndev > len(jax.devices()):
        raise SystemExit(
            f"--devices {ndev} > {len(jax.devices())} available on this "
            f"backend ({jax.default_backend()}). For a fake multi-device "
            "CPU mesh run with XLA_FLAGS="
            "--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu "
            "(row_mesh(D) on fewer real devices otherwise fails deep in "
            "sharding with a confusing broadcast-shape error).")
    bz, by, bx = args.base_shape
    results = []
    for D in [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev]:
        # weak scaling: z-extent grows with D -> n/D constant
        shape = (bz * D, by, bx)
        op = laplacian_dia(shape, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        B = jnp.asarray(rng.standard_normal((op.n, args.k)), dtype=jnp.float32)
        mesh = row_mesh(D)
        dop = partition_dia(op, D)
        # fixed-iteration run (tol=0 would never stop; use tiny tol + cap)
        t0 = time.time()
        X, info = solve_sbcgrq_dist(dop, B, mesh, tol=1e-30,
                                    max_iter=args.iters)
        it = int(info.iterations)
        compile_s = time.time() - t0
        t0 = time.time()
        X, info = solve_sbcgrq_dist(dop, B * 1.000001, mesh, tol=1e-30,
                                    max_iter=args.iters)
        it = int(info.iterations)
        wall = time.time() - t0
        per_iter = wall / max(it, 1)
        halo_bytes = 2 * args.k * dop.bw * 4
        rec = {
            "devices": D,
            "n": op.n,
            "rows_per_device": op.n // D,
            "iters": it,
            "s_per_iter": round(per_iter, 6),
            "halo_bytes_per_dev_per_iter": halo_bytes,
            "compile_s": round(compile_s, 2),
        }
        if results:
            rec["weak_scaling_eff"] = round(
                results[0]["s_per_iter"] / per_iter, 4
            )
        results.append(rec)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
