"""Converged-column deflation (T-C4, solvers/deflate.py).

SURVEY.md §8 hard part 4: with spread-difficulty
RHS the worst column keeps the whole block iterating; deflation must (a)
still converge every column, (b) cut the bandwidth-weighted SpMM work
(matvec_cols) vs the fixed-width solve, (c) report per-RHS iteration counts.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from blockcg import solve_sbcgrq, solve_sbcgrq_deflated
from blockcg.problems import laplacian_dia, laplacian_scipy, random_block


def _spread_rhs(shape, k_easy, k_hard, seed=0):
    """RHS block with spread difficulty: 'easy' columns are single analytic
    Laplacian eigenvectors (a Krylov method retires each in ~2 iterations);
    'hard' columns are dense random (full-spectrum). The easy columns span
    almost no useful directions for the hard ones, so deflating them loses
    little shared-Krylov benefit — the O'Leary variable-block-size sweet
    spot."""
    lx, ly = shape
    ii = np.arange(lx)[:, None] + 1.0
    jj = np.arange(ly)[None, :] + 1.0

    def eig(p, q):
        v = np.sin(np.pi * p * ii / (lx + 1)) * np.sin(np.pi * q * jj / (ly + 1))
        return (v / np.linalg.norm(v)).reshape(-1)

    rng = np.random.default_rng(seed)
    # mid-spectrum modes: the lowest modes (p=q=1) legitimately take longer
    # (their solution norm ~1/lambda amplifies the f32 floor), which would
    # blur the easy/hard split this fixture exists to create
    modes = [(p, q) for p in range(2, 6) for q in range(2, 5)]
    cols = [eig(*modes[j % len(modes)]) for j in range(k_easy)]
    for j in range(k_hard):
        c = rng.standard_normal(lx * ly)
        cols.append(c / np.linalg.norm(c))  # equal norms: the S-monitor's
        # rounding coupling floors each column at ~eps * max_i relres_i *
        # ||b_i||/||b_j||; mismatched norms would mask the easy columns
    return np.stack(cols, axis=1)


def _true_relres(a, X, B):
    X = np.asarray(X, np.float64)
    B = np.asarray(B, np.float64)
    return np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)


def test_deflated_converges_and_cuts_matvec_cols():
    shape = (48, 48)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(_spread_rhs(shape, k_easy=12, k_hard=4), jnp.float32)
    tol = 1e-6

    Xf, inf_f = solve_sbcgrq(op, B, tol=tol, max_iter=600)
    Xd, inf_d = solve_sbcgrq_deflated(op, B, tol=tol, max_iter=600)

    assert bool(inf_d.converged.all())
    # True residual: the S-norm monitor drifts from the true residual by
    # f32 rounding in BOTH variants (that is what replacement repairs);
    # deflation must be no worse than the fixed-width solve.
    assert _true_relres(a, Xd, B).max() <= max(
        2 * _true_relres(a, Xf, B).max(), 5 * tol
    )
    # The "done" bar: >= 15% matvec-bandwidth reduction on a
    # spread-difficulty block vs the fixed-width solve.
    fixed_cols = int(inf_f.matvecs) * B.shape[1]
    defl_cols = int(inf_d.matvec_cols)
    assert defl_cols <= 0.85 * fixed_cols, (defl_cols, fixed_cols)


def test_per_rhs_iters_spread():
    shape = (48, 48)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(_spread_rhs(shape, k_easy=12, k_hard=4), jnp.float32)
    X, info = solve_sbcgrq(op, B, tol=1e-6, max_iter=600)
    pr = np.asarray(info.per_rhs_iters)
    assert pr.shape == (16,)
    # easy columns (few eigen-modes) retire far sooner than the random ones
    assert pr[:12].max() < 0.5 * pr[12:].min()
    assert pr.max() <= int(info.iterations)
    # a column's count is the number of iterations it was still unconverged
    assert (pr > 0).all()


def test_deflated_matches_fixed_width_solution():
    shape = (32, 32)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(random_block(a.shape[0], 16, seed=3), jnp.float32)
    tol = 1e-6
    Xd, info = solve_sbcgrq_deflated(op, B, tol=tol, max_iter=800)
    assert bool(info.converged.all())
    assert _true_relres(a, Xd, B).max() <= 5 * tol
    # per-column counts sum to <= total iterations x width trivially; the
    # scalar `iterations` is the stage sum
    assert int(info.iterations) >= int(np.asarray(info.per_rhs_iters).max())


def test_deflated_block_codec_operator():
    """Deflation restarts re-enter to_internal at every width — exercise a
    merged spin-major codec operator (coeff algebra must stay k x k at each
    stage width)."""
    from blockcg.problems import dirac_cbdia

    op = dirac_cbdia(6, m=1.0, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    B = jnp.asarray(rng.standard_normal((op.n, 16)), jnp.float32)
    tol = 1e-5
    Xd, info = solve_sbcgrq_deflated(op, B, tol=tol, max_iter=400)
    assert bool(info.converged.all())
    R = np.asarray(op.matmat(Xd)) - np.asarray(B)
    rr = np.linalg.norm(R, axis=0) / np.linalg.norm(np.asarray(B), axis=0)
    assert rr.max() <= 5 * tol


def test_vector_tol():
    shape = (32, 32)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(random_block(a.shape[0], 8, seed=7), jnp.float32)
    tols = np.full(8, 1e-6)
    tols[:4] = 1e-3  # loose columns may stop early
    X, info = solve_sbcgrq(op, B, tol=jnp.asarray(tols, jnp.float32),
                           max_iter=800)
    assert bool(info.converged.all())
    rr = _true_relres(a, X, B)
    assert rr[4:].max() <= 5e-6
    pr = np.asarray(info.per_rhs_iters)
    assert pr[:4].max() < pr[4:].min()  # loose columns retired earlier


def test_deflated_dist_matches_single():
    """Distributed deflation (width-halving restarts over the row-sharded
    solver): converges every column, cuts matvec_cols vs the fixed-width
    distributed solve, and matches the single-device deflated result."""
    import jax
    import pytest

    if len(jax.devices()) < 4:
        pytest.skip("needs the multi-device (fake CPU) mesh")
    from blockcg.parallel import (
        partition_dia, row_mesh, solve_sbcgrq_deflated_dist,
        solve_sbcgrq_dist,
    )

    shape = (48, 48)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(_spread_rhs(shape, k_easy=12, k_hard=4), jnp.float32)
    tol = 1e-6
    mesh = row_mesh(4)
    dop = partition_dia(op, 4)

    Xf, inf_f = solve_sbcgrq_dist(dop, B, mesh, tol=tol, max_iter=600)
    Xd, inf_d = solve_sbcgrq_deflated_dist(dop, B, mesh, tol=tol,
                                           max_iter=600)
    assert bool(inf_d.converged.all())
    assert _true_relres(a, Xd, B).max() <= 1e-5  # ~10x f32 drift documented
    fixed_cols = int(inf_f.matvecs) * B.shape[1]
    assert int(inf_d.matvec_cols) <= 0.85 * fixed_cols
    # per-RHS counts: easy columns retire earlier than the hard ones
    pr = np.asarray(inf_d.per_rhs_iters)
    assert pr[:12].max() < pr[12:].min()
    # ...and the advertised equivalence: same algorithm as the
    # single-device deflation driver (stage structure and work within
    # reduction-order slack; solutions agree at the solve tolerance)
    Xs, inf_s = solve_sbcgrq_deflated(op, B, tol=tol, max_iter=600)
    assert abs(int(inf_d.iterations) - int(inf_s.iterations)) <= 5
    assert abs(int(inf_d.matvec_cols) - int(inf_s.matvec_cols)) <= \
        8 * B.shape[1]
    assert np.abs(np.asarray(Xd) - np.asarray(Xs)).max() <= 5e-4


def test_small_n_auto_defaults_to_fixed_width(monkeypatch):
    """Auto mode on a HIGH-LATENCY device skips halving below the n
    threshold (the exploratory restart's ~8 slow dispatches dwarf a small
    solve). Simulated here by faking the latency cache; on CPU (us
    dispatch) the normal tests above keep halving on."""
    from blockcg.solvers import deflate

    shape = (48, 48)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(_spread_rhs(shape, k_easy=12, k_hard=4), jnp.float32)
    tol = 1e-6

    monkeypatch.setitem(deflate._LATENCY_CACHE, jax.default_backend(), 0.03)
    Xd, inf_d = solve_sbcgrq_deflated(op, B, tol=tol, max_iter=600)
    Xf, inf_f = solve_sbcgrq(op, B, tol=tol, max_iter=600)
    # single fixed-width stage: identical iteration count and full-width
    # column-passes (no cut), same solution
    assert int(inf_d.iterations) == int(inf_f.iterations)
    assert int(inf_d.matvec_cols) == int(inf_f.matvecs) * B.shape[1]
    assert np.abs(np.asarray(Xd) - np.asarray(Xf)).max() <= 1e-6

    # explicit restart_overhead_s (measured-seconds gate) bypasses the
    # size default — halving engages and cuts column-passes
    Xd2, inf_d2 = solve_sbcgrq_deflated(op, B, tol=tol, max_iter=600,
                                        restart_overhead_s=0.0)
    assert int(inf_d2.matvec_cols) < int(inf_f.matvecs) * B.shape[1]
