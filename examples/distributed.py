#!/usr/bin/env python
"""Row-sharded distributed solves over a device mesh.

On the GPUs of one host it runs as it stands; without them, run on a fake
8-device CPU mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/distributed.py
Across hosts, call jax.distributed.initialize() first and the same code
runs SPMD over all devices (see scaling_bench.py --distributed).
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import numpy as np
import jax.numpy as jnp

from blockcg.parallel import (
    partition_cbdia, partition_dia, row_mesh, solve_sbcgrq_dist,
)
from blockcg.problems import dirac_cbdia, laplacian_dia

D = len(jax.devices())
mesh = row_mesh(D)
rng = np.random.default_rng(0)

# Scalar stencil: rows sharded, ring halo exchange + psum Grams.
op = laplacian_dia((8 * D, 64), dtype=jnp.float32)
dop = partition_dia(op, D)
B = jnp.asarray(rng.standard_normal((op.n, 8)), dtype=jnp.float32)
X, info = solve_sbcgrq_dist(dop, B, mesh, tol=1e-6)
print(f"dist Laplacian n={op.n} over {D} devices: "
      f"iters={int(info.iterations)}")

# Block lattice operator: site-sharded merged fields, halo-sourced slab
# corrections for the crossing t-hops.
if D in (2, 4, 8):
    opb = dirac_cbdia(8, m=0.5, dtype=jnp.float32)
    dopb = partition_cbdia(opb, D)
    Bb = jnp.asarray(rng.standard_normal((opb.n, 4)), dtype=jnp.float32)
    Xb, infob = solve_sbcgrq_dist(dopb, Bb, mesh, tol=1e-6)
    print(f"dist Dirac     n={opb.n} over {D} devices: "
          f"iters={int(infob.iterations)}")
