"""Preconditioned block CG (solve_pbcg) vs oracles."""

import numpy as np
import jax.numpy as jnp
import scipy.sparse as sp

import blockcg as bc
from blockcg.operators import DenseOperator, DIAOperator
from blockcg.solvers.pbcg import jacobi_preconditioner


def _scaled_spd_dia(n, seed=0, spread=4.0):
    """Badly diagonally-scaled SPD banded matrix (Jacobi's home turf)."""
    rng = np.random.default_rng(seed)
    s = np.exp(spread * rng.standard_normal(n))  # rows scaled over decades
    offsets = [-2, -1, 0, 1, 2]
    base = sp.diags(
        [np.full(n - abs(o), -1.0) for o in offsets[:2]]
        + [np.full(n, 5.0)]
        + [np.full(n - abs(o), -1.0) for o in offsets[3:]],
        offsets,
    ).tocsr()
    D = sp.diags(np.sqrt(s))
    return (D @ base @ D).tocsr()


def test_pbcg_jacobi_matches_direct_and_cuts_iterations():
    n, k = 1024, 4
    a = _scaled_spd_dia(n)
    op = DIAOperator.from_scipy(a, dtype=jnp.float64)
    M = jacobi_preconditioner(op)
    rng = np.random.default_rng(1)
    B = jnp.asarray(rng.standard_normal((n, k)))
    Xp, ip = bc.solve_pbcg(op, B, M, tol=1e-10, max_iter=2000)
    Xb, ib = bc.solve_bcg(op, B, tol=1e-10, max_iter=2000)
    rel = np.abs(
        np.linalg.norm(a @ np.asarray(Xp) - np.asarray(B), axis=0)
        / np.linalg.norm(np.asarray(B), axis=0)
    ).max()
    assert rel < 1e-9
    # Jacobi fixes the scaling: far fewer iterations than plain BCG.
    assert int(ip.iterations) < int(ib.iterations) * 0.7, (
        int(ip.iterations), int(ib.iterations))


def test_pbcg_identity_preconditioner_equals_bcg():
    """M = I reduces PBCG to plain BCG (same iterates, f64-exact-ish)."""
    from blockcg.solvers.pbcg import JacobiPreconditioner

    n, k = 256, 3
    rng = np.random.default_rng(2)
    V = rng.standard_normal((n, 2 * n))
    A = V @ V.T + n * np.eye(n)
    op = DenseOperator(A=jnp.asarray(A))
    M = JacobiPreconditioner(dinv_int=jnp.ones((1, n)))
    B = jnp.asarray(rng.standard_normal((n, k)))
    Xp, ip = bc.solve_pbcg(op, B, M, tol=1e-10, max_iter=500)
    Xb, ib = bc.solve_bcg(op, B, tol=1e-10, max_iter=500)
    assert abs(int(ip.iterations) - int(ib.iterations)) <= 1
    assert np.abs(np.asarray(Xp) - np.asarray(Xb)).max() < 1e-7


def test_pbcg_on_merged_block_operator():
    """Jacobi on the const-hop (merged layout) Dirac operator: the
    per-spin inverse-diagonal repeats over the k rows."""
    from blockcg.problems import dirac_cbdia
    from blockcg.problems.dirac import bdia_scipy

    op = dirac_cbdia(4, m=0.5, dtype=jnp.float32)
    M = jacobi_preconditioner(op)
    rng = np.random.default_rng(3)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    X, info = bc.solve_pbcg(op, B, M, tol=1e-5, max_iter=300)
    a = bdia_scipy(op.to_block_dia())
    r = np.asarray(B) - a @ np.asarray(X)
    rel = (np.linalg.norm(r, axis=0)
           / np.linalg.norm(np.asarray(B), axis=0)).max()
    assert rel < 1e-4


def test_psbcgrq_identity_equals_sbcgrq():
    from blockcg.solvers.pbcg import JacobiPreconditioner

    n, k = 256, 4
    rng = np.random.default_rng(10)
    V = rng.standard_normal((n, 2 * n))
    A = V @ V.T + n * np.eye(n)
    op = DenseOperator(A=jnp.asarray(A))
    M = JacobiPreconditioner(dinv_int=jnp.ones((1, n)))
    B = jnp.asarray(rng.standard_normal((n, k)))
    Xp, ip = bc.solve_psbcgrq(op, B, M, tol=1e-10, max_iter=500)
    Xs, isb = bc.solve_sbcgrq(op, B, tol=1e-10, max_iter=500)
    assert abs(int(ip.iterations) - int(isb.iterations)) <= 1
    assert np.abs(np.asarray(Xp) - np.asarray(Xs)).max() < 1e-7


def test_psbcgrq_jacobi_scaled_system():
    n, k = 1024, 6
    a = _scaled_spd_dia(n, seed=11)
    op = DIAOperator.from_scipy(a, dtype=jnp.float64)
    M = jacobi_preconditioner(op)
    rng = np.random.default_rng(12)
    B = jnp.asarray(rng.standard_normal((n, k)))
    Xp, ip = bc.solve_psbcgrq(op, B, M, tol=1e-10, max_iter=2000)
    Xu, iu = bc.solve_sbcgrq(op, B, tol=1e-10, max_iter=2000)
    rel = np.abs(
        np.linalg.norm(a @ np.asarray(Xp) - np.asarray(B), axis=0)
        / np.linalg.norm(np.asarray(B), axis=0)
    ).max()
    # The monitor is the M-NORM relative residual (standard for PCG); the
    # 2-norm residual can exceed it by up to sqrt(kappa(M)) on this badly
    # scaled system — assert against that bound, not the raw tol.
    d = a.diagonal()
    bound = 1e-10 * np.sqrt(d.max() / d.min()) * 10
    assert rel < max(bound, 1e-7), (rel, bound)
    assert int(ip.iterations) < int(iu.iterations) * 0.7, (
        int(ip.iterations), int(iu.iterations))


def test_psbcgrq_rank_robust_vs_pbcg():
    """Duplicate RHS columns: the rQ stabilization keeps the solve exact
    where plain PBCG's k x k Grams degenerate."""
    n = 512
    a = _scaled_spd_dia(n, seed=13, spread=2.0)
    op = DIAOperator.from_scipy(a, dtype=jnp.float64)
    M = jacobi_preconditioner(op)
    rng = np.random.default_rng(14)
    b = rng.standard_normal(n)
    B = jnp.asarray(np.stack([b, b, rng.standard_normal(n)], axis=1))
    Xp, ip = bc.solve_psbcgrq(op, B, M, tol=1e-9, max_iter=2000)
    rel = np.abs(
        np.linalg.norm(a @ np.asarray(Xp) - np.asarray(B), axis=0)
        / np.linalg.norm(np.asarray(B), axis=0)
    ).max()
    assert rel < 1e-7
