"""Device solvers (jitted lax.while_loop) vs f64 oracles and direct solves.

SURVEY.md §5.2 item 2: f64 device solvers validated against scipy/direct;
f32 device solvers validated for residual <= tol and agreement with the f64
reference within f32 slack.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse.linalg as spla

from blockcg import solve_cg, solve_bcg, solve_sbcgrq
from blockcg.operators import DenseOperator
from blockcg.problems import (
    laplacian_dia,
    laplacian_scipy,
    random_block,
    random_spd,
    dirac_bell,
)
from blockcg.solvers.reference import ref_cg, ref_sbcgrq


def _relres(a_scipy, X, B):
    X, B = np.asarray(X, dtype=np.float64), np.asarray(B, dtype=np.float64)
    return np.abs(
        np.linalg.norm(a_scipy @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    ).max()


# ---------------------------------------------------------------- CG ----


def test_cg_dense_f64_matches_direct():
    A = random_spd(100, seed=0)
    b = random_block(100, 1, seed=1)[:, 0]
    op = DenseOperator(A=jnp.asarray(A))
    x, info = solve_cg(op, jnp.asarray(b), tol=1e-12, max_iter=500)
    assert bool(info.converged.all())
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b), rtol=1e-8)
    # iteration count within slack of the f64 oracle
    _, it_ref = ref_cg(A, b, tol=1e-12)
    assert abs(int(info.iterations) - it_ref) <= 3


def test_cg_laplacian_f32_vs_scipy():
    """North-star config 1 shrunk: 2D Laplacian, plain CG, f32 on device."""
    shape = (32, 32)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float32)
    b = random_block(a.shape[0], 1, seed=2)[:, 0]
    x, info = solve_cg(op, jnp.asarray(b, dtype=jnp.float32), tol=1e-5, max_iter=2000)
    assert bool(info.converged.all())
    assert _relres(a, np.asarray(x)[:, None], b[:, None]) <= 2e-5
    x_sp, _ = spla.cg(a, b, rtol=1e-5)
    assert np.linalg.norm(np.asarray(x, dtype=np.float64) - x_sp) / np.linalg.norm(
        x_sp
    ) < 1e-3


def test_cg_block_rhs():
    """CG accepts an (n,1) block."""
    A = random_spd(50, seed=3)
    b = random_block(50, 1, seed=4)
    op = DenseOperator(A=jnp.asarray(A))
    x, info = solve_cg(op, jnp.asarray(b), tol=1e-10)
    assert x.shape == (50, 1)
    assert bool(info.converged.all())


def test_cg_max_iter_cap():
    A = random_spd(80, seed=5, delta=0.01)
    b = random_block(80, 1, seed=6)[:, 0]
    op = DenseOperator(A=jnp.asarray(A))
    _, info = solve_cg(op, jnp.asarray(b), tol=1e-14, max_iter=3)
    assert int(info.iterations) == 3
    assert not bool(info.converged.all())


def test_cg_history():
    A = random_spd(60, seed=7)
    b = random_block(60, 1, seed=8)[:, 0]
    op = DenseOperator(A=jnp.asarray(A))
    _, info = solve_cg(op, jnp.asarray(b), tol=1e-10, max_iter=200, record_history=True)
    h = np.asarray(info.history)
    it = int(info.iterations)
    assert np.isfinite(h[:it]).all() and np.isnan(h[it:]).all()
    # residual history ends below tol
    assert h[it - 1] <= 1e-10


# --------------------------------------------------------------- BCG ----


def test_bcg_dense_f64():
    A = random_spd(150, seed=9)
    B = random_block(150, 6, seed=10)
    op = DenseOperator(A=jnp.asarray(A))
    X, info = solve_bcg(op, jnp.asarray(B), tol=1e-10, max_iter=300)
    assert bool(info.converged.all())
    res = np.linalg.norm(A @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-9


def test_bcg_fewer_iterations_than_cg():
    """North-star config 2 property: block CG needs fewer iterations than
    the worst per-RHS CG on the same system (shared Krylov space)."""
    shape = (24, 24)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float64)
    B = random_block(a.shape[0], 8, seed=11)
    X, info = solve_bcg(op, jnp.asarray(B), tol=1e-8, max_iter=2000)
    assert bool(info.converged.all())
    it_cg_max = 0
    for j in range(4):
        _, it = ref_cg(a, B[:, j], tol=1e-8)
        it_cg_max = max(it_cg_max, it)
    assert int(info.iterations) < it_cg_max


# ------------------------------------------------------------ SBCGrQ ----


def test_sbcgrq_dense_f64_matches_oracle():
    A = random_spd(300, seed=12)
    B = random_block(300, 8, seed=13)
    op = DenseOperator(A=jnp.asarray(A))
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-11, max_iter=200)
    assert bool(info.converged.all())
    res = np.linalg.norm(A @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10
    _, it_ref = ref_sbcgrq(A, B, tol=1e-11)
    assert abs(int(info.iterations) - it_ref) <= 5


def test_sbcgrq_f32_laplacian():
    """North-star config 3 shrunk: 3D Laplacian, SBCGrQ, f32."""
    shape = (8, 8, 8)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = random_block(a.shape[0], 8, seed=14)
    Bj = jnp.asarray(B, dtype=jnp.float32)
    X, info = solve_sbcgrq(op, Bj, tol=1e-5, max_iter=500)
    assert bool(info.converged.all())
    assert _relres(a, X, B) <= 5e-5


def test_sbcgrq_f32_dirac():
    """North-star config 4 shrunk: BSR 4x4 Dirac-like operator, SBCGrQ."""
    L = 4
    op = dirac_bell(L, m=0.5, dtype=jnp.float32)
    from blockcg.problems import dirac_scipy

    a = dirac_scipy(L, m=0.5)
    B = random_block(op.n, 4, seed=15)
    X, info = solve_sbcgrq(op, jnp.asarray(B, dtype=jnp.float32), tol=1e-5, max_iter=500)
    assert bool(info.converged.all())
    assert _relres(a, X, B) <= 5e-5


def test_sbcgrq_residual_replacement():
    """T-C5: periodic true-residual replacement still converges and reports
    the extra matvecs."""
    A = random_spd(200, seed=16)
    B = random_block(200, 6, seed=17)
    op = DenseOperator(A=jnp.asarray(A))
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-10, max_iter=300, replace_every=10)
    assert bool(info.converged.all())
    assert int(info.matvecs) > int(info.iterations) + 1  # extra SpMMs counted
    res = np.linalg.norm(A @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-9


def test_sbcgrq_rebase_replacement_f64():
    """replace_mode='rebase' (keep-P) in f64: replacement every iteration
    must not inflate the iteration count — the unitary re-basing preserves
    the Krylov momentum exactly (solvers/common.py residual_rebase)."""
    A = random_spd(200, seed=16)
    B = random_block(200, 6, seed=17)
    op = DenseOperator(A=jnp.asarray(A))
    X0, info0 = solve_sbcgrq(op, jnp.asarray(B), tol=1e-10, max_iter=300)
    X, info = solve_sbcgrq(
        op, jnp.asarray(B), tol=1e-10, max_iter=300, replace_every=1,
        replace_mode="rebase",
    )
    assert bool(info.converged.all())
    assert abs(int(info.iterations) - int(info0.iterations)) <= 3
    res = np.linalg.norm(A @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-9


def test_sbcgrq_restart_replacement_f32_frequent():
    """replace_mode='restart' must stay robust in f32 even with frequent
    replacement and near-converged columns (the regime where keep-P rebasing
    measurably diverges — see sbcgrq.py module docstring)."""
    shape = (12, 12)
    from blockcg.problems import laplacian_dia, laplacian_scipy

    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = random_block(a.shape[0], 8, seed=21)
    X, info = solve_sbcgrq(
        op, jnp.asarray(B, jnp.float32), tol=1e-6, max_iter=500,
        replace_every=10,
    )
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-5


def test_sbcgrq_invariant_on_device():
    """Debug-mode invariant B - A X = Q S, checked by stepping the device
    solver with max_iter=j for increasing j (cheap at this size)."""
    A = random_spd(80, seed=18)
    B = random_block(80, 4, seed=19)
    op = DenseOperator(A=jnp.asarray(A))
    Bj = jnp.asarray(B)
    for j in (1, 3, 7):
        X, info = solve_sbcgrq(op, Bj, tol=1e-13, max_iter=j)
        # relres reported from S-column norms must match the true residual
        true = np.linalg.norm(A @ np.asarray(X) - B, axis=0) / np.linalg.norm(
            B, axis=0
        )
        np.testing.assert_allclose(np.asarray(info.relres), true, rtol=1e-6, atol=1e-12)


def test_bcg_and_bcgdq_on_merged_block_operator():
    """Regression: solvers' per-RHS norms/Grams must contract the merged
    (m = bs*k, ns) internal rows (codec) — solve_bcg once crashed here."""
    import blockcg as bc
    from blockcg.problems import dirac_cbdia
    from blockcg.problems.dirac import bdia_scipy

    op = dirac_cbdia(4, m=0.5, dtype=jnp.float32)
    rng = np.random.default_rng(23)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    a = bdia_scipy(op.to_block_dia())
    for solver in (bc.solve_bcg, bc.solve_bcgdq):
        X, info = solver(op, B, tol=1e-5, max_iter=300)
        r = np.asarray(B) - a @ np.asarray(X)
        rel = (np.linalg.norm(r, axis=0)
               / np.linalg.norm(np.asarray(B), axis=0)).max()
        assert rel < 1e-4, solver


def test_sbcgrq_zero_rhs_column():
    """A zero column in B must not poison the solve (bnorm guard + QR
    jitter): the other columns converge, the zero column returns zero."""
    op = laplacian_dia((32, 32), dtype=jnp.float64)
    rng = np.random.default_rng(70)
    B = rng.standard_normal((op.n, 4))
    B[:, 2] = 0.0
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-10, max_iter=500)
    Xn = np.asarray(X)
    assert np.isfinite(Xn).all()
    assert np.abs(Xn[:, 2]).max() < 1e-8
    a = laplacian_scipy((32, 32))
    for j in (0, 1, 3):
        r = a @ Xn[:, j] - B[:, j]
        assert np.linalg.norm(r) / np.linalg.norm(B[:, j]) < 1e-9


def test_sbcgrq_duplicate_rhs_columns():
    """Identical RHS columns (rank-deficient B) — the rQ stabilization's
    jittered Cholesky must keep the solve finite and correct."""
    op = laplacian_dia((32, 32), dtype=jnp.float64)
    rng = np.random.default_rng(71)
    b = rng.standard_normal(op.n)
    B = np.stack([b, b, rng.standard_normal(op.n)], axis=1)
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-9, max_iter=500)
    a = laplacian_scipy((32, 32))
    Xn = np.asarray(X)
    for j in range(3):
        r = a @ Xn[:, j] - B[:, j]
        assert np.linalg.norm(r) / np.linalg.norm(B[:, j]) < 1e-8


def test_sbcgrq_warm_start():
    """X0 warm start: starting at the exact solution converges immediately;
    starting nearby converges faster than from zero."""
    op = laplacian_dia((32, 32), dtype=jnp.float64)
    rng = np.random.default_rng(72)
    B = jnp.asarray(rng.standard_normal((op.n, 3)))
    X, i0 = solve_sbcgrq(op, B, tol=1e-10, max_iter=500)
    _, i_exact = solve_sbcgrq(op, B, X0=X, tol=1e-8, max_iter=500)
    assert int(i_exact.iterations) <= 1
    Xn = np.asarray(X) + 1e-6 * rng.standard_normal(np.asarray(X).shape)
    _, i_near = solve_sbcgrq(op, B, X0=jnp.asarray(Xn), tol=1e-8,
                                max_iter=500)
    assert int(i_near.iterations) < int(i0.iterations)


def test_block_solvers_k_equals_n():
    """k = n (square RHS block): converges in ~1 block iteration."""
    n = 24
    A = random_spd(n, seed=73)
    op = DenseOperator(A=jnp.asarray(A))
    rng = np.random.default_rng(73)
    B = jnp.asarray(rng.standard_normal((n, n)))
    X, info = solve_sbcgrq(op, B, tol=1e-10, max_iter=50)
    assert int(info.iterations) <= 3
    r = A @ np.asarray(X) - np.asarray(B)
    assert (np.linalg.norm(r, axis=0)
            / np.linalg.norm(np.asarray(B), axis=0)).max() < 1e-9


def test_sbcgrq_breakdown_flag():
    """Numerically rank-deficient RHS blocks (near-duplicate columns,
    kappa(B) ~ 1e14) are beyond any CholeskyQR repair: the solver cannot
    converge, and must SAY so — info.breakdown flags >1% achieved
    orthogonality error (k x k-side detector, solvers/common.qr_ortho_err).
    Healthy blocks report breakdown False."""
    import numpy as np

    from blockcg.problems import laplacian_dia

    op = laplacian_dia((16, 16), dtype=jnp.float32)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((op.n, 16))
    idx = np.arange(op.n)
    for j in range(8):  # near-parallel low-frequency columns
        B[:, j] = np.sin((idx + 1) * (j + 1) / 16 * 2 * np.pi / op.n)
    assert np.linalg.cond(B) > 1e12  # numerically rank-deficient in f32
    X, info = solve_sbcgrq(op, jnp.asarray(B, jnp.float32), tol=1e-6,
                           max_iter=120)
    assert not bool(info.converged.all())
    assert bool(info.breakdown)

    Bh = jnp.asarray(rng.standard_normal((op.n, 8)), jnp.float32)
    X, info = solve_sbcgrq(op, Bh, tol=1e-6, max_iter=500)
    assert not bool(info.breakdown)
    assert bool(info.converged.all())
