#!/usr/bin/env python
"""Lattice block operators: the const-hop operator, gauged (Z2/U(1))
links as value-carrying masks, and even-odd Schur preconditioning.

python examples/lattice_gauged.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax.numpy as jnp

import blockcg as bc
from blockcg.problems import (
    dirac_cbdia, dirac_gauged_cbdia, dirac_gauged_eo, solve_dirac_eo,
)

rng = np.random.default_rng(0)
L = 8  # 8^4 lattice, 4-spin blocks

# Translation-invariant Dirac-like operator (north-star config 4 shape):
# hop matrices are compile-time constants, only boundary masks stream.
op = dirac_cbdia(L, m=0.5, dtype=jnp.float32)
B = jnp.asarray(rng.standard_normal((op.n, 12)), dtype=jnp.float32)
X, info = bc.solve_sbcgrq(op, B, tol=1e-6)
print(f"const-hop   n={op.n:>8} iters={int(info.iterations)}")

# Z2 gauge links ride the SAME operator as per-site mask VALUES.
gop = dirac_gauged_cbdia(L, m=0.5, dtype=jnp.float32)
X, info = bc.solve_sbcgrq(gop, B, tol=1e-6)
print(f"Z2-gauged   n={gop.n:>8} iters={int(info.iterations)}")

# Even-odd Schur: half-size system, ~2x fewer iterations.
eo = dirac_gauged_eo(L, m=0.5, dtype=jnp.float32)
X, info = solve_dirac_eo(eo, B, tol=1e-6)
print(f"gauged-EO   n={gop.n:>8} schur iters={int(info.iterations)}")

# U(1) phase links: complex Hermitian system, realified K1/K2 hops — the
# entire hot loop runs in real f32 arithmetic.
uop = dirac_gauged_cbdia(L, m=0.5, dtype=jnp.complex64)
Bc = (rng.standard_normal((uop.n, 6))
      + 1j * rng.standard_normal((uop.n, 6))).astype(np.complex64)
X, info = bc.solve_sbcgrq(uop, Bc, tol=1e-6)
print(f"U1-gauged   n={uop.n:>8} iters={int(info.iterations)}")

# MATRIX-valued (SU(N)-style) links: per-site orthogonal link matrices do
# not factorize onto the const-hop path — the general per-site block
# kernel carries them (smaller lattice: per-site blocks stream from HBM).
from blockcg.problems import dirac_gauged_matrix

mop = dirac_gauged_matrix(max(L // 2, 4), m=0.5, dtype=jnp.float32)
Bm = jnp.asarray(rng.standard_normal((mop.n, 12)), dtype=jnp.float32)
X, info = bc.solve_sbcgrq(mop, Bm, tol=1e-6)
print(f"SU(N)-links n={mop.n:>8} iters={int(info.iterations)}")
