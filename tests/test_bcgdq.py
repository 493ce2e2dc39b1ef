"""BCGdQ (Dubrulle direction-QR variant) tests — SURVEY.md §1.1 ladder."""

import numpy as np
import pytest
import jax.numpy as jnp

import blockcg as bc
from blockcg.operators import DenseOperator
from blockcg.problems import laplacian_dia, random_spd, random_block
from blockcg.problems.random_spd import random_hpd, random_block_c


def _relres(A, X, B):
    R = B - A @ X
    return (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()


def test_bcgdq_dense_spd():
    n, k = 192, 6
    A = random_spd(n, delta=0.5, seed=0)
    op = DenseOperator(A=jnp.asarray(A))
    B = jnp.asarray(random_block(n, k, seed=1))
    X, info = bc.solve_bcgdq(op, B, tol=1e-10, max_iter=400)
    assert _relres(A, np.asarray(X), np.asarray(B)) < 1e-9
    assert bool(info.converged.all())


def test_bcgdq_matches_bcg_iterations():
    """Exact-arithmetic equivalence with BCG: iteration counts agree within
    small slack on a well-conditioned problem."""
    op = laplacian_dia((32, 32), dtype=jnp.float64)
    rng = np.random.default_rng(2)
    B = jnp.asarray(rng.standard_normal((op.n, 8)))
    _, i_dq = bc.solve_bcgdq(op, B, tol=1e-8, max_iter=500)
    _, i_b = bc.solve_bcg(op, B, tol=1e-8, max_iter=500)
    assert abs(int(i_dq.iterations) - int(i_b.iterations)) <= 3
    assert bool(i_dq.converged.all())


def test_bcgdq_rank_robustness():
    """Duplicate RHS columns sink plain BCG's Gram; dQ must still converge."""
    n, k = 160, 6
    A = random_spd(n, delta=0.2, seed=3)
    op = DenseOperator(A=jnp.asarray(A, dtype=jnp.float32))
    rng = np.random.default_rng(4)
    B = rng.standard_normal((n, k))
    B[:, -1] = B[:, 0] + 1e-5 * rng.standard_normal(n)  # near-duplicate
    Bj = jnp.asarray(B, dtype=jnp.float32)
    X, info = bc.solve_bcgdq(op, Bj, tol=1e-5, max_iter=400, qr_passes=2)
    assert _relres(A, np.asarray(X, np.float64), B) < 1e-4


def test_bcgdq_complex():
    n, k = 128, 5
    A = random_hpd(n, delta=1.0, seed=5)
    op = DenseOperator(A=jnp.asarray(A, dtype=jnp.complex128))
    B = jnp.asarray(random_block_c(n, k, seed=6), dtype=jnp.complex128)
    X, info = bc.solve_bcgdq(op, B, tol=1e-10, max_iter=400)
    assert _relres(A, np.asarray(X), np.asarray(B)) < 1e-9


def test_bcgrq_alias():
    assert bc.solve_bcgrq is bc.solve_sbcgrq


def test_bcga_matches_direct_f64():
    """BCGA (A-orthonormal directions — the last Dubrulle ladder rung) vs a
    direct solve, and the in-loop A-orthonormality invariant by proxy
    (convergence at BCG-like iteration counts with well-scaled k x k
    algebra)."""
    import blockcg as bc

    n, k = 300, 8
    a_np = random_spd(n, seed=12)
    op = DenseOperator(A=jnp.asarray(a_np))
    B = random_block(n, k, seed=13)
    X, info = bc.solve_bcga(op, jnp.asarray(B), tol=1e-10, max_iter=400)
    assert bool(info.converged.all())
    res = np.linalg.norm(a_np @ np.asarray(X) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-9
    # same Krylov space as BCG: iteration counts agree within slack
    Xb, infob = bc.solve_bcg(op, jnp.asarray(B), tol=1e-10, max_iter=400)
    assert abs(int(info.iterations) - int(infob.iterations)) <= 5


def test_bcga_badly_scaled_directions():
    """Columns scaled across decades: BCGA's normalized directions keep the
    k x k algebra conditioned (the rung's raison d'etre)."""
    import blockcg as bc

    n, k = 400, 6
    a_np = random_spd(n, seed=21)
    op = DenseOperator(A=jnp.asarray(a_np))
    rng = np.random.default_rng(22)
    B = rng.standard_normal((n, k)) * (10.0 ** np.arange(-3, 3))
    X, info = bc.solve_bcga(op, jnp.asarray(B), tol=1e-8, max_iter=600)
    assert bool(info.converged.all())
    res = np.linalg.norm(a_np @ np.asarray(X) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-7
