"""Complex Hermitian support: conjugate-correct solvers + realified path.

Reference parity: the reference's solvers are written for complex Hermitian
systems (Eigen, lattice QCD; SURVEY.md §1). Two routes here:
  - true-complex: the solvers run on complex dtypes directly (conjugate-
    correct Grams/Cholesky/CholQR);
  - realified: operators/realify.py maps A Hermitian to the real symmetric
    [[Ar,-Ai],[Ai,Ar]] on stacked (re, im) fields.
"""

import numpy as np
import pytest
import jax.numpy as jnp


import blockcg as bc
from blockcg.operators import DenseOperator, realify
from blockcg.problems import dirac_bdia, dirac_cbdia
from blockcg.problems.dirac import bdia_scipy
from blockcg.problems.random_spd import random_hpd, random_block_c


def _hpd_op(n, seed=0, dtype=jnp.complex128):
    return DenseOperator(A=jnp.asarray(random_hpd(n, delta=1.0, seed=seed),
                                       dtype=dtype))


def _relres(A, X, B):
    R = B - A @ X
    return (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()


# ------------------------------------------------- true-complex solvers ----


def test_cg_complex():
    n = 96
    op = _hpd_op(n)
    b = jnp.asarray(random_block_c(n, 1)[:, 0], dtype=jnp.complex128)
    x, info = bc.solve_cg(op, b, tol=1e-10, max_iter=500)
    A = np.asarray(op.A)
    assert _relres(A, np.asarray(x)[:, None], np.asarray(b)[:, None]) < 1e-9
    assert bool(info.converged.all())


def test_bcg_complex():
    n, k = 128, 6
    op = _hpd_op(n, seed=1)
    B = jnp.asarray(random_block_c(n, k, seed=2), dtype=jnp.complex128)
    X, info = bc.solve_bcg(op, B, tol=1e-10, max_iter=500)
    assert _relres(np.asarray(op.A), np.asarray(X), np.asarray(B)) < 1e-9
    assert bool(info.converged.all())


def test_sbcgrq_complex():
    n, k = 160, 8
    op = _hpd_op(n, seed=3)
    B = jnp.asarray(random_block_c(n, k, seed=4), dtype=jnp.complex128)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-10, max_iter=500)
    assert _relres(np.asarray(op.A), np.asarray(X), np.asarray(B)) < 1e-9
    assert bool(info.converged.all())
    # direct-solve agreement
    Xd = np.linalg.solve(np.asarray(op.A), np.asarray(B))
    assert np.abs(np.asarray(X) - Xd).max() / np.abs(Xd).max() < 1e-8


def test_sbcgrq_complex_dirac():
    op = dirac_bdia(3, m=0.7, dtype=jnp.complex128)
    a = bdia_scipy(op)
    rng = np.random.default_rng(5)
    B = jnp.asarray(
        rng.standard_normal((op.n, 4)) + 1j * rng.standard_normal((op.n, 4)),
        dtype=jnp.complex128,
    )
    X, info = bc.solve_sbcgrq(op, B, tol=1e-10, max_iter=300)
    assert _relres(a.toarray(), np.asarray(X), np.asarray(B)) < 1e-9


# --------------------------------------------------------- realified path --


def test_realify_dense_apply_and_solve():
    n, k = 128, 5
    op = _hpd_op(n, seed=6, dtype=jnp.complex128)
    rop = realify(op)
    B = jnp.asarray(random_block_c(n, k, seed=7), dtype=jnp.complex128)
    # apply equivalence
    Y1 = np.asarray(op.matmat(B))
    Y2 = np.asarray(rop.matmat(B))
    assert np.abs(Y1 - Y2).max() / np.abs(Y1).max() < 1e-12
    # solve through the real stacked field path
    X, info = bc.solve_sbcgrq(rop, B, tol=1e-10, max_iter=600)
    assert X.dtype == jnp.complex128
    assert _relres(np.asarray(op.A), np.asarray(X), np.asarray(B)) < 1e-9


@pytest.mark.parametrize("builder", [dirac_cbdia, dirac_bdia])
def test_realify_dirac_apply(builder):
    op = builder(3, m=0.7, dtype=jnp.complex128)
    rop = realify(op)
    a = bdia_scipy(op.to_block_dia() if hasattr(op, "to_block_dia") else op)
    rng = np.random.default_rng(8)
    X = rng.standard_normal((op.n, 3)) + 1j * rng.standard_normal((op.n, 3))
    want = a @ X
    got = np.asarray(rop.matmat(jnp.asarray(X, dtype=jnp.complex128)))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_realify_dirac_solve_matches_complex_solve():
    op = dirac_cbdia(3, m=0.7, dtype=jnp.complex128)
    rop = realify(op)
    rng = np.random.default_rng(9)
    B = jnp.asarray(
        rng.standard_normal((op.n, 4)) + 1j * rng.standard_normal((op.n, 4)),
        dtype=jnp.complex128,
    )
    Xr, ir = bc.solve_sbcgrq(rop, B, tol=1e-9, max_iter=400)
    Xc, ic = bc.solve_sbcgrq(op, B, tol=1e-9, max_iter=400)
    a = bdia_scipy(op.to_block_dia()).toarray()
    assert _relres(a, np.asarray(Xr), np.asarray(B)) < 1e-8
    assert _relres(a, np.asarray(Xc), np.asarray(B)) < 1e-8
    # same solution, comparable iteration counts (same spectrum)
    assert np.abs(np.asarray(Xr) - np.asarray(Xc)).max() < 1e-6
    assert abs(int(ir.iterations) - int(ic.iterations)) <= 10


def test_realified_nnz_and_shape():
    op = dirac_cbdia(3, m=0.7, dtype=jnp.complex64)
    rop = realify(op)
    assert rop.shape == op.shape
    assert rop.nnz == op.nnz
    assert rop.real_op.n == 2 * op.n


def test_refined_realified_reaches_1e10():
    """Regression: astype must widen the realified wrapper's cdtype (once a
    meta field tree_map couldn't change — refinement stalled at ~6e-8)."""
    import blockcg as bc
    from blockcg.operators.base import astype

    rng = np.random.default_rng(50)
    V = rng.standard_normal((64, 96)) + 1j * rng.standard_normal((64, 96))
    A = (V @ V.conj().T + 64 * np.eye(64)).astype(np.complex64)
    rop = realify(DenseOperator(A=jnp.asarray(A)))
    wide = astype(rop, jnp.float64)
    assert wide.cdtype == jnp.complex128
    B = (rng.standard_normal((64, 3))
         + 1j * rng.standard_normal((64, 3))).astype(np.complex64)
    X, info = bc.solve_refined(rop, B, tol=1e-10)
    R = A.astype(np.complex128) @ np.asarray(X, np.complex128) - B
    rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()
    assert rel < 1e-9
    assert bool(info.converged.all())
