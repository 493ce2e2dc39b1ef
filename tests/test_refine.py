"""Mixed-precision refinement to 1e-10 with an f32 operator (T-C5)."""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg import solve_refined
from blockcg.operators import DenseOperator
from blockcg.operators.base import astype as op_astype
from blockcg.problems import (
    dirac_bdia,
    bdia_scipy,
    laplacian_dia,
    laplacian_scipy,
    random_block,
    random_spd,
)


def test_refined_laplacian_f32_to_1e10():
    """North-star tolerance with an f32 compute operator (config-3 logic)."""
    shape = (12, 12, 12)
    op = laplacian_dia(shape, dtype=jnp.float32)
    a = laplacian_scipy(shape)
    B = random_block(op.n, 8, seed=0)
    X, info = solve_refined(op, jnp.asarray(B), tol=1e-10, inner_tol=1e-5)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10
    assert int(info.iterations) <= 4  # 2-3 cycles expected


def test_refined_dense_f32():
    """Matrix data rounded to f32: the true f64 operator must be supplied for
    the outer residual, else the tolerance floors at the rounding error."""
    A = random_spd(200, seed=1)
    op = DenseOperator(A=jnp.asarray(A, dtype=jnp.float32))
    op64 = DenseOperator(A=jnp.asarray(A))
    B = random_block(200, 4, seed=2)
    X, info = solve_refined(op, jnp.asarray(B), tol=1e-11, inner_tol=1e-4, op64=op64)
    res = np.linalg.norm(A @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-11
    # and without op64 the floor is visible (documents the semantics)
    X2, _ = solve_refined(op, jnp.asarray(B), tol=1e-11, inner_tol=1e-4, max_cycles=3)
    res2 = np.linalg.norm(A @ np.asarray(X2) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res2.max() > 1e-9


def test_refined_dirac_f32():
    op = dirac_bdia(4, m=0.5, bc="periodic", dtype=jnp.float32)
    a = bdia_scipy(op)
    B = random_block(op.n, 4, seed=3)
    X, info = solve_refined(op, jnp.asarray(B), tol=1e-10, inner_tol=1e-5)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10


def test_refined_bcg_inner():
    op = laplacian_dia((16, 16), dtype=jnp.float32)
    a = laplacian_scipy((16, 16))
    B = random_block(op.n, 4, seed=4)
    X, info = solve_refined(
        op, jnp.asarray(B), tol=1e-10, inner_tol=1e-4, inner_solver="bcg"
    )
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10


def test_refined_checkpoint_resume(tmp_path):
    """Kill-and-resume: a fresh call with the same checkpoint path warm-starts
    from the saved X and needs fewer cycles (SURVEY.md §6)."""
    shape = (10, 10, 10)
    op = laplacian_dia(shape, dtype=jnp.float32)
    a = laplacian_scipy(shape)
    B = random_block(op.n, 4, seed=9)
    ck = str(tmp_path / "solve.npz")
    # "crashed" run: only 1 cycle allowed
    X1, info1 = solve_refined(
        op, jnp.asarray(B), tol=1e-10, inner_tol=1e-4, max_cycles=1,
        checkpoint_path=ck,
    )
    assert not bool(info1.converged.all())
    # resumed run finishes
    X2, info2 = solve_refined(
        op, jnp.asarray(B), tol=1e-10, inner_tol=1e-4, checkpoint_path=ck
    )
    assert bool(info2.converged.all())
    assert int(info2.iterations) < 4
    res = np.linalg.norm(a @ np.asarray(X2) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10


def test_op_astype():
    op = laplacian_dia((8, 8), dtype=jnp.float32)
    op64 = op_astype(op, jnp.float64)
    assert op64.diags.dtype == jnp.float64
    assert op64.offsets == op.offsets
