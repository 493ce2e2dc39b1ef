#!/usr/bin/env python
"""Scattered (unstructured) sparsity end-to-end: auto format selection,
RCM-densified sparse-tile path with bf16 tiles, mixed-precision
refinement to 1e-10, and operator save/load so the host-side preprocessing
runs once.

Runs on CPU or a GPU unmodified: python examples/scattered_sparse.py
"""
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax.numpy as jnp

import blockcg as bc
from blockcg.operators import CSROperator, from_scipy_auto
from blockcg.problems import delaunay_laplacian
from blockcg.utils import load_operator, save_operator

rng = np.random.default_rng(0)

# An unstructured-mesh SPD matrix: graph Laplacian of a Delaunay
# triangulation (avg degree ~7, no stencil structure at all).
n = 20_000
a = delaunay_laplacian(n, seed=0)

# Auto selection: host-side inspection picks the container from a rate
# model measured on the card. RCM densifies this mesh into tiles, but the
# hardware gather of the ELL/CSR formats is still faster on a GPU, so
# that is the pick (tile_dtype would apply to the tile format).
t0 = time.time()
op = from_scipy_auto(a, dtype=jnp.float32, tile_dtype=jnp.bfloat16,
                     verbose=True)
print(f"build: {time.time()-t0:.2f} s, format {type(op).__name__}")

# ... which is worth persisting: build once, load every run after.
with tempfile.TemporaryDirectory() as d:
    path = pathlib.Path(d) / "op.npz"
    save_operator(path, op)
    op = load_operator(path)

# Solve. The operator applies in its (permuted, padded) internal order;
# to_solver_order/from_solver_order convert at the API boundary (identity
# for non-reordered formats, so this pattern is format-agnostic).
B = rng.standard_normal((n, 16)).astype(np.float32)
Bi = op.to_solver_order(jnp.asarray(B))
X, info = bc.solve_sbcgrq(op, Bi, tol=1e-5)
Xo = np.asarray(op.from_solver_order(X), np.float64)
res = np.linalg.norm(a @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
print(f"SBCGrQ   iters={int(info.iterations):>4} true relres={res.max():.2e}")

# Beyond f32: mixed-precision refinement with an f64 outer operator
# reaches 1e-10 (T-C5). Refinement solves in the operator's order: a tile
# operator's reordered_scipy applies the same permutation/padding. f64
# leaves must be created inside an x64 scope (the global-x64-off default
# silently truncates them to f32 otherwise).
import jax

a_op = op.reordered_scipy(a) if hasattr(op, "reordered_scipy") else a
with jax.enable_x64(True):
    op64 = CSROperator.from_scipy(a_op, dtype=jnp.float64)
X, info = bc.solve_refined(op, Bi, tol=1e-10, inner_tol=1e-3, op64=op64)
Xo = np.asarray(op.from_solver_order(X), np.float64)
res = np.linalg.norm(a @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
print(f"refined  cycles={int(info.iterations):>3} true relres={res.max():.2e}")
