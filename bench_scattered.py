#!/usr/bin/env python
"""Scattered-sparsity SpMM bench — the tile-density -> throughput curve.

SURVEY.md §3.2 T-K1's general-sparsity half (reference R1 handles arbitrary
CSR): measures SpMM throughput on genuinely unstructured SPD matrices
through each available path:

  csr         XLA gather + segment-sum (the honest generic fallback)
  ell         XLA fixed-width row gather
  rcm_f32     RCM-reordered sparse-tile operator, f32 tiles
  rcm_bf16    same, bf16 tile storage (f32 compute/accumulate)

Problems span the density axis: Delaunay mesh (deg ~7), random geometric
graphs at deg 10/20/40, and a no-locality uniform random graph (the case
tiling CANNOT help — documented, not hidden). Each line reports the tile
fill so the fill -> Gnnz/s relation is explicit; padded-tile memory traffic
is the model (throughput ~= fill x tile-load bandwidth). These lines are
what operators/auto.py's rate-model constants are fitted to.

Usage: python bench_scattered.py [--n 32768] [--k 32] [--out FILE]
Emits one JSON line per (problem, format); needs a GPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import jax
import jax.numpy as jnp

from bench import measure_apply
from chip_smoke import card_identity, require_gpus


def problems(n: int):
    from blockcg.problems import (
        delaunay_laplacian,
        random_regular_spd,
        rgg_laplacian,
        uniform_random_spd,
    )

    yield "delaunay", delaunay_laplacian(n, seed=0)
    for deg in (10, 20, 40):
        yield f"rgg_deg{deg}", rgg_laplacian(n, degree=deg, seed=0)
    yield "uniform_deg8", uniform_random_spd(min(n, 16384), degree=8.0, seed=0)
    # exact-regular expander: the no-locality endpoint (the random-row
    # gather bound of the ELL/CSR formats)
    yield "regular_deg8", random_regular_spd(min(n, 16384), degree=8, seed=0)


def formats(a):
    from blockcg.operators import CSROperator, ELLOperator, TiledOperator

    yield "csr", lambda: CSROperator.from_scipy(a, dtype=jnp.float32)
    yield "ell", lambda: ELLOperator.from_scipy(a, dtype=jnp.float32)
    yield "rcm_f32", lambda: TiledOperator.from_scipy(
        a, dtype=jnp.float32, reorder="rcm", max_pad_bytes=4 << 30
    )
    yield "rcm_bf16", lambda: TiledOperator.from_scipy(
        a, dtype=jnp.float32, reorder="rcm", tile_dtype=jnp.bfloat16,
        max_pad_bytes=4 << 30
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--out", default=None,
                    help="also append the lines to this file")
    ap.add_argument("--problems", default=None,
                    help="comma-separated name filter")
    args = ap.parse_args()
    require_gpus(1)
    card = card_identity()

    rng = np.random.default_rng(0)
    want = set(args.problems.split(",")) if args.problems else None
    for pname, a in problems(args.n):
        if want and pname not in want:
            continue
        nnz, n = a.nnz, a.shape[0]
        for fname, build in formats(a):
            try:
                op = build()
            except ValueError as e:  # too scattered for the tile format
                line = {"bench": "scattered_spmm", "problem": pname,
                        "format": fname, "n": n, "nnz": int(nnz),
                        "refused": str(e)[:120]}
                print(json.dumps(line), flush=True)
                continue
            Xt = jnp.asarray(rng.standard_normal((args.k, op.n)),
                             dtype=jnp.float32)
            dt = measure_apply(op, Xt)
            line = {
                "bench": "scattered_spmm", "problem": pname, "format": fname,
                "n": n, "nnz": int(nnz), "k": args.k,
                "avg_deg": round(nnz / n, 2),
                "gnnzs": nnz / dt / 1e9,
                "spmm_ms": dt * 1e3,
                "device": jax.devices()[0].device_kind,
                "card": card,
            }
            if hasattr(op, "fill"):
                line["fill_pct"] = round(100 * op.fill, 3)
                line["ntiles"] = op.ntiles
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
