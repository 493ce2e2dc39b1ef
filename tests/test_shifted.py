"""Multi-shift CG (T-S4): one Krylov space, per-shift solutions vs direct."""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.operators import DenseOperator
from blockcg.solvers.shifted import solve_shifted_cg
from blockcg.problems import laplacian_dia, laplacian_scipy, random_block, random_spd


def test_shifted_cg_dense_matches_direct():
    A = random_spd(150, seed=0)
    b = random_block(150, 1, seed=1)[:, 0]
    sigmas = [0.0, 0.1, 1.0, 10.0]
    op = DenseOperator(A=jnp.asarray(A))
    X, info = solve_shifted_cg(op, jnp.asarray(b), sigmas, tol=1e-10, max_iter=500)
    assert bool(info.converged.all())
    for j, s in enumerate(sigmas):
        want = np.linalg.solve(A + s * np.eye(150), b)
        got = np.asarray(X[:, j])
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < 1e-8, (j, s, err)


def test_shifted_cg_laplacian_f32():
    shape = (24, 24)
    op = laplacian_dia(shape, dtype=jnp.float32)
    a = laplacian_scipy(shape)
    b = random_block(op.n, 1, seed=2)[:, 0].astype(np.float32)
    sigmas = [0.0, 0.05, 0.5]
    X, info = solve_shifted_cg(op, jnp.asarray(b), sigmas, tol=1e-5, max_iter=3000)
    assert bool(info.converged.all())
    import scipy.sparse as sp

    for j, s in enumerate(sigmas):
        As = a + s * sp.eye(op.n)
        r = np.linalg.norm(As @ np.asarray(X[:, j], dtype=np.float64) - b)
        assert r / np.linalg.norm(b) < 5e-5, (j, s)


def test_shifted_cg_one_matvec_per_iteration():
    """The whole point: nshift solutions for the price of one CG."""
    A = random_spd(100, seed=3)
    b = random_block(100, 1, seed=4)[:, 0]
    op = DenseOperator(A=jnp.asarray(A))
    X, info = solve_shifted_cg(op, jnp.asarray(b), [0.0, 0.3, 3.0], tol=1e-10)
    assert int(info.matvecs) == int(info.iterations)  # shifts ride for free


def test_shifted_cg_rejects_block():
    op = DenseOperator(A=jnp.asarray(random_spd(20, seed=5)))
    with pytest.raises(ValueError):
        solve_shifted_cg(op, jnp.zeros((20, 2)), [0.0])


def test_shifted_cg_complex_hermitian():
    """Regression: complex HPD systems once failed at trace time (complex
    rho in a real while_loop carry)."""
    from blockcg.operators import DenseOperator
    from blockcg.solvers.shifted import solve_shifted_cg

    rng = np.random.default_rng(51)
    V = rng.standard_normal((64, 96)) + 1j * rng.standard_normal((64, 96))
    A = (V @ V.conj().T + 64 * np.eye(64)).astype(np.complex128)
    op = DenseOperator(A=jnp.asarray(A))
    b = jnp.asarray(rng.standard_normal(64) + 1j * rng.standard_normal(64))
    sig = [0.0, 0.5, 2.0]
    X, info = solve_shifted_cg(op, b, sig, tol=1e-10, max_iter=500)
    for j, sg in enumerate(sig):
        r = (A + sg * np.eye(64)) @ np.asarray(X[:, j]) - np.asarray(b)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-9
