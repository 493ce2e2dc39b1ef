#!/usr/bin/env python
"""Basic solves: CG, BCG, and the flagship SBCGrQ on 2D/3D Laplacians,
plus mixed-precision refinement to 1e-10 (SURVEY.md north-star configs).

Runs on CPU or a GPU unmodified: python examples/basic_solve.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax.numpy as jnp

import blockcg as bc
from blockcg.problems import laplacian_dia

rng = np.random.default_rng(0)

# Single RHS: plain CG on a 2D 5-point Laplacian (north-star config 1).
op = laplacian_dia((128, 128), dtype=jnp.float32)
b = jnp.asarray(rng.standard_normal(op.n), dtype=jnp.float32)
x, info = bc.solve_cg(op, b, tol=1e-6)
print(f"CG       n={op.n:>9} iters={int(info.iterations):>4} "
      f"relres={float(info.relres.max()):.2e}")

# Block of 32 RHS: SBCGrQ on a 3D 7-point Laplacian (config 3).
op = laplacian_dia((64, 64, 64), dtype=jnp.float32)
B = jnp.asarray(rng.standard_normal((op.n, 32)), dtype=jnp.float32)
X, info = bc.solve_sbcgrq(op, B, tol=1e-6)
print(f"SBCGrQ   n={op.n:>9} k=32 iters={int(info.iterations):>4} "
      f"relres={float(info.relres.max()):.2e}")

# Beyond f32: iterative refinement to 1e-10 (f64 outer / f32 inner).
# Verify on the host in true float64 — applying the f32 operator without
# jax_enable_x64 would silently measure at the f32 floor instead.
from blockcg.problems import laplacian_scipy

X, info = bc.solve_refined(op, B, tol=1e-10)
a64 = laplacian_scipy((64, 64, 64))
R = a64 @ np.asarray(X, np.float64) - np.asarray(B, np.float64)
rel = (np.linalg.norm(R, axis=0)
       / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
print(f"refined  n={op.n:>9} k=32 cycles={int(info.iterations)} "
      f"true relres={rel:.2e}")

# Many shifts, one Krylov space: (A + sigma I) X = B for all sigma at once.
Xs, info = bc.solve_shifted_sbcgrq(op, B[:, :8], [0.0, 0.5, 2.0], tol=1e-6)
print(f"shifted  n={op.n:>9} k=8 x 3 shifts, SpMMs={int(info.matvecs)}")

# Badly scaled systems: Jacobi-preconditioned stabilized block CG.
import scipy.sparse as sp
from blockcg.operators import DIAOperator

n = 1 << 14
scale = np.exp(2.0 * rng.standard_normal(n))
base = sp.diags([np.full(n - 1, -1.0), np.full(n, 4.0),
                 np.full(n - 1, -1.0)], [-1, 0, 1]).tocsr()
Ds = sp.diags(np.sqrt(scale))
a = (Ds @ base @ Ds).tocsr()
sop = DIAOperator.from_scipy(a, dtype=jnp.float32)
M = bc.jacobi_preconditioner(sop)
Bs = jnp.asarray(rng.standard_normal((n, 8)), dtype=jnp.float32)
_, iu = bc.solve_sbcgrq(sop, Bs, tol=1e-5, max_iter=2000)
_, ipc = bc.solve_psbcgrq(sop, Bs, M, tol=1e-5, max_iter=2000)
print(f"psbcgrq  n={n:>9} jacobi: {int(ipc.iterations)} iters "
      f"(unpreconditioned: {int(iu.iterations)})")
