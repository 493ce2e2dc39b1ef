"""Automatic operator-format selection (operators/auto.py)."""

import numpy as np
import jax.numpy as jnp

from blockcg import solve_sbcgrq
from blockcg.operators import (
    CSROperator,
    DIAOperator,
    ELLOperator,
    TiledOperator,
    from_scipy_auto,
)
from blockcg.problems import (
    delaunay_laplacian,
    laplacian_scipy,
    random_block,
    uniform_random_spd,
)


def test_auto_picks_dia_for_stencil():
    a = laplacian_scipy((24, 24))
    op = from_scipy_auto(a, dtype=jnp.float64)
    assert isinstance(op, DIAOperator)
    X = random_block(a.shape[0], 3, seed=0)
    np.testing.assert_allclose(
        np.asarray(op.matmat(jnp.asarray(X))), a @ X, rtol=1e-12, atol=1e-12
    )


def test_auto_picks_rcm_tiled_for_mesh():
    """An unstructured mesh densifies under RCM (fill far above the
    expander's), yet its fill stays below the break-even floor against
    the measured gather rate, so the selector picks a gather format."""
    from blockcg.operators.auto import _predicted_rcm_fill

    a = delaunay_laplacian(3000, seed=1)
    op = from_scipy_auto(a, dtype=jnp.float64)
    assert isinstance(op, (ELLOperator, CSROperator))
    fill, _, _ = _predicted_rcm_fill(a)
    assert 0.005 < fill < 0.35


def test_auto_picks_gather_for_expander():
    a = uniform_random_spd(4096, degree=8.0, seed=2)
    op = from_scipy_auto(a, dtype=jnp.float64)
    assert isinstance(op, (ELLOperator, CSROperator))


def test_auto_format_agnostic_solve():
    """The documented generic pattern works for every auto choice,
    including the permuted-order tiled case."""
    for a in (laplacian_scipy((16, 16)), delaunay_laplacian(1500, seed=3),
              uniform_random_spd(1024, degree=6.0, seed=4)):
        op = from_scipy_auto(a, dtype=jnp.float64)
        n = a.shape[0]
        B = random_block(n, 4, seed=5)
        Bi = op.to_solver_order(jnp.asarray(B))
        X, info = solve_sbcgrq(op, Bi, tol=1e-9, max_iter=2000)
        assert bool(info.converged.all())
        Xo = np.asarray(op.from_solver_order(X))[:n]
        res = np.linalg.norm(a @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
        assert res.max() <= 1e-8, type(op).__name__


def test_auto_falls_back_when_tile_budget_exceeded():
    """The selector's job: a mesh whose padded tiles exceed the memory
    budget must land on a gather format, not raise."""
    a = delaunay_laplacian(3000, seed=6)
    op = from_scipy_auto(a, dtype=jnp.float64, max_pad_bytes=1 << 20)
    assert isinstance(op, (ELLOperator, CSROperator))


def test_tiled_rcm_metadata_survives_pytree_roundtrip():
    """RCM perm/n0/nnz ride the pytree: tree_map and astype round-trips must
    preserve the row-order contract (a dropped perm silently returns
    permuted answers)."""
    import jax
    from blockcg.operators.base import astype as op_astype

    a = delaunay_laplacian(1500, seed=7)
    op = TiledOperator.from_scipy(a, dtype=jnp.float32, reorder="rcm")
    assert op.perm is not None
    op2 = jax.tree.map(lambda x: x, op)
    op3 = op_astype(op, jnp.float64)
    for o in (op2, op3):
        assert o.perm is not None and o.n0 == op.n0
        # logical count (matrix nnz + identity pad rows), not the padded
        # tile upper bound
        assert o.nnz == a.nnz + (op.n - op.n0)
        assert o.nnz < o.ntiles * o.T * o.T
    X = random_block(1500, 2, seed=8)
    got = op3.from_solver_order(op3.matmat(op3.to_solver_order(jnp.asarray(X))))
    np.testing.assert_allclose(np.asarray(got), a @ X, rtol=1e-10, atol=1e-10)


def test_operator_save_load_roundtrip(tmp_path):
    """save_operator/load_operator: array leaves, static metadata (offsets
    tuples, RCM perm/n0), and bf16 storage all survive the npz round-trip."""
    import jax.numpy as jnp

    from blockcg.operators import DIAOperator
    from blockcg.utils import load_operator, save_operator
    from blockcg.problems import laplacian_scipy

    a = laplacian_scipy((12, 12))
    ops = [
        DIAOperator.from_scipy(a, dtype=jnp.float64),
        TiledOperator.from_scipy(delaunay_laplacian(1500, seed=9),
                                 dtype=jnp.float32, reorder="rcm",
                                 tile_dtype=jnp.bfloat16),
    ]
    for op in ops:
        p = tmp_path / f"{type(op).__name__}.npz"
        save_operator(p, op)
        op2 = load_operator(p)
        assert type(op2) is type(op)
        n0 = getattr(op, "n0", None) or op.shape[0]
        X = random_block(n0, 2, seed=10)
        Xi = op.to_solver_order(jnp.asarray(X, dtype=op.dtype))
        np.testing.assert_array_equal(
            np.asarray(op.matmat(Xi)), np.asarray(op2.matmat(Xi))
        )
        if isinstance(op, TiledOperator):
            assert op2.tiles.dtype == jnp.bfloat16
            np.testing.assert_array_equal(np.asarray(op.perm),
                                          np.asarray(op2.perm))
