"""Determinism / golden-regression tests (SURVEY.md §5.2 item 5).

Fixed-seed problems with golden iteration counts (± small slack: f32
reduction order is deterministic for a fixed partitioning, but kernel-path
changes may legitimately move counts by an iteration or two)."""

import numpy as np
import jax.numpy as jnp

import blockcg as bc
from blockcg.problems import laplacian_dia


def _B(n, k, seed=42):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((n, k)), dtype=jnp.float32)


GOLDEN = {
    # (solver, config): (iterations, slack) — calibrated on the CPU backend
    "cg_64sq": (165, 6),
    "bcg_64sq_k8": (97, 5),
    "sbcgrq_64sq_k8": (95, 5),
    "sbcgrq_16cube_k16": (33, 3),
}


def test_golden_cg():
    op = laplacian_dia((64, 64), dtype=jnp.float32)
    _, info = bc.solve_cg(op, _B(op.n, 1)[:, 0], tol=1e-6, max_iter=1000)
    want, slack = GOLDEN["cg_64sq"]
    assert abs(int(info.iterations) - want) <= slack, int(info.iterations)


def test_golden_bcg_and_sbcgrq():
    op = laplacian_dia((64, 64), dtype=jnp.float32)
    B = _B(op.n, 8)
    _, ib = bc.solve_bcg(op, B, tol=1e-6, max_iter=1000)
    _, isq = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=1000)
    wb, sb = GOLDEN["bcg_64sq_k8"]
    wq, sq = GOLDEN["sbcgrq_64sq_k8"]
    assert abs(int(ib.iterations) - wb) <= sb, int(ib.iterations)
    assert abs(int(isq.iterations) - wq) <= sq, int(isq.iterations)
    # block solvers beat per-RHS CG on iterations (the reference's config-2
    # comparison): k=8 shared Krylov must need fewer than single-RHS CG.
    wc, _ = GOLDEN["cg_64sq"]
    assert int(ib.iterations) < wc
    assert int(isq.iterations) < wc


def test_golden_3d():
    op = laplacian_dia((16, 16, 16), dtype=jnp.float32)
    _, info = bc.solve_sbcgrq(op, _B(op.n, 16), tol=1e-6, max_iter=500)
    want, slack = GOLDEN["sbcgrq_16cube_k16"]
    assert abs(int(info.iterations) - want) <= slack, int(info.iterations)


def test_repeat_solve_bitwise_identical():
    """Same inputs, same partitioning -> bit-identical X (determinism)."""
    op = laplacian_dia((32, 32), dtype=jnp.float32)
    B = _B(op.n, 4)
    X1, _ = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=300)
    X2, _ = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=300)
    assert np.array_equal(np.asarray(X1), np.asarray(X2))
