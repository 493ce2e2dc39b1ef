"""Shifted block SBCGrQ tests (T-S4 block flavor, solvers/shifted_block.py)."""

import numpy as np
import pytest
import jax.numpy as jnp

import blockcg as bc
from blockcg.operators import DenseOperator
from blockcg.problems import laplacian_dia, laplacian_scipy, random_spd
from blockcg.problems.random_spd import random_hpd, random_block, random_block_c
from blockcg.solvers.shifted_block import solve_shifted_sbcgrq


def _check_all_shifts(A, B, Xs, sigmas, tol):
    n = A.shape[0]
    for j, s in enumerate(sigmas):
        R = B - (A + s * np.eye(n)) @ np.asarray(Xs[j], B.dtype)
        rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()
        assert rel < tol, (j, s, rel)


def test_shifted_sbcgrq_dense_f64():
    n, k = 192, 6
    A = random_spd(n, delta=0.25, seed=0)
    op = DenseOperator(A=jnp.asarray(A))
    B = random_block(n, k, seed=1)
    sigmas = [0.0, 0.3, 1.7, 10.0]
    Xs, info = solve_shifted_sbcgrq(op, jnp.asarray(B), sigmas, tol=1e-9,
                                    max_iter=400)
    assert bool(info.converged.all())
    _check_all_shifts(A, B, Xs, sigmas, 1e-8)
    # one SpMM per iteration, shared across shifts (no setup apply: Q_0
    # comes from the QR of B directly)
    assert int(info.matvecs) == int(info.iterations)


def test_shifted_seed_matches_sbcgrq():
    """sigma = 0 must reproduce the plain SBCGrQ solution."""
    op = laplacian_dia((32, 32), dtype=jnp.float64)
    rng = np.random.default_rng(2)
    B = jnp.asarray(rng.standard_normal((op.n, 5)))
    Xs, _ = solve_shifted_sbcgrq(op, B, [0.0, 1.0], tol=1e-10, max_iter=600)
    X0, _ = bc.solve_sbcgrq(op, B, tol=1e-10, max_iter=600)
    err = np.abs(np.asarray(Xs[0]) - np.asarray(X0)).max()
    assert err < 1e-7


def test_shifted_sbcgrq_laplacian_f32():
    op = laplacian_dia((64, 64), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((op.n, 8)).astype(np.float32)
    sigmas = [0.0, 0.5, 4.0]
    Xs, info = solve_shifted_sbcgrq(op, jnp.asarray(B), sigmas, tol=1e-5,
                                    max_iter=800)
    a = laplacian_scipy((64, 64)).toarray()
    _check_all_shifts(a, B.astype(np.float64), np.asarray(Xs, np.float64),
                      sigmas, 1e-4)


def test_shifted_sbcgrq_complex():
    n, k = 128, 4
    A = random_hpd(n, delta=0.5, seed=4)
    op = DenseOperator(A=jnp.asarray(A, dtype=jnp.complex128))
    B = random_block_c(n, k, seed=5)
    sigmas = [0.0, 0.8, 3.0]
    Xs, info = solve_shifted_sbcgrq(op, jnp.asarray(B, dtype=jnp.complex128),
                                    sigmas, tol=1e-9, max_iter=500)
    _check_all_shifts(A, B, Xs, sigmas, 1e-8)


def test_shifted_larger_sigma_converges_faster():
    """Bigger shifts improve conditioning: their residuals converge sooner
    (per-shift relres at the common stopping iteration are ordered)."""
    n, k = 160, 4
    A = random_spd(n, delta=0.05, seed=6)
    op = DenseOperator(A=jnp.asarray(A))
    B = random_block(n, k, seed=7)
    Xs, info = solve_shifted_sbcgrq(op, jnp.asarray(B), [0.0, 5.0], tol=1e-12,
                                    max_iter=30)
    rel = np.asarray(info.relres).max(axis=1)
    assert rel[1] < rel[0]


def test_shifted_block_k1_matches_scalar_shifted_cg():
    """k = 1 block multi-shift vs Jegerlehner scalar multi-shift: same
    solutions from two independent derivations (Lanczos LDL^H vs residual
    collinearity)."""
    op = laplacian_dia((32, 32), dtype=jnp.float64)
    rng = np.random.default_rng(8)
    b = jnp.asarray(rng.standard_normal(op.n))
    sigmas = [0.0, 0.7, 2.5]
    Xs, ib = solve_shifted_sbcgrq(op, b[:, None], sigmas, tol=1e-10,
                                  max_iter=800)
    xs, isc = bc.solve_shifted_cg(op, b, sigmas, tol=1e-10, max_iter=800)
    for j in range(len(sigmas)):
        # solve_shifted_cg returns (n, nshift); the block solver (nshift, n, k)
        err = np.abs(np.asarray(Xs[j][:, 0]) - np.asarray(xs[:, j])).max()
        assert err < 1e-7, (j, err)


def test_shifted_sbcgrq_merged_block_op():
    """Multi-shift block solve through a merged-layout const-hop operator."""
    from blockcg.problems import dirac_cbdia
    from blockcg.problems.dirac import bdia_scipy
    from blockcg.solvers.shifted_block import solve_shifted_sbcgrq

    op = dirac_cbdia(4, m=0.5, dtype=jnp.float64)
    rng = np.random.default_rng(21)
    B = jnp.asarray(rng.standard_normal((op.n, 3)))
    sigmas = [0.0, 0.4, 1.5]
    Xs, info = solve_shifted_sbcgrq(op, B, sigmas, tol=1e-9, max_iter=400)
    a = bdia_scipy(op.to_block_dia())
    Bn = np.asarray(B)
    for j, sg in enumerate(sigmas):
        R = (a @ np.asarray(Xs[j]) + sg * np.asarray(Xs[j])) - Bn
        rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(Bn, axis=0)).max()
        assert rel < 1e-7, (j, sg, rel)
