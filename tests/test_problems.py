"""Problem generators and operator formats agree with scipy (SURVEY.md §5.2)."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from blockcg.operators import BSROperator, CSROperator, DIAOperator, ELLOperator
from blockcg.problems import (
    dirac_bell,
    dirac_scipy,
    laplacian_dia,
    laplacian_ell,
    laplacian_csr,
    laplacian_scipy,
)


@pytest.mark.parametrize("shape", [(16,), (9, 7), (12, 12), (5, 6, 7)])
def test_laplacian_formats_agree(shape):
    a = laplacian_scipy(shape)
    n = a.shape[0]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 3))
    want = a @ X

    Xj = jnp.asarray(X, dtype=jnp.float64)
    for op in (
        laplacian_dia(shape, dtype=jnp.float64),
        laplacian_ell(shape, dtype=jnp.float64),
        laplacian_csr(shape, dtype=jnp.float64),
    ):
        got = np.asarray(op(Xj))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        assert op.shape == (n, n)

    # single-vector path
    got = np.asarray(laplacian_dia(shape, dtype=jnp.float64)(Xj[:, 0]))
    np.testing.assert_allclose(got, want[:, 0], rtol=1e-12, atol=1e-12)


def test_laplacian_spd_and_symmetric():
    a = laplacian_scipy((10, 11)).toarray()
    np.testing.assert_allclose(a, a.T)
    evals = np.linalg.eigvalsh(a)
    assert evals.min() > 0


def test_laplacian_nnz():
    want = laplacian_scipy((8, 8)).nnz
    # ELL counts true nonzeros; DIA counts band entries (>= true nnz since
    # boundary-zeroed band slots are structural).
    assert laplacian_ell((8, 8)).nnz == want
    assert laplacian_dia((8, 8)).nnz >= want


@pytest.mark.parametrize("L", [2, 3, 4])
def test_dirac_matches_scipy(L):
    a = dirac_scipy(L)
    op = dirac_bell(L, dtype=jnp.float64)
    n = a.shape[0]
    assert op.n == n == 4 * L**4
    rng = np.random.default_rng(1)
    X = rng.standard_normal((n, 2))
    got = np.asarray(op(jnp.asarray(X)))
    np.testing.assert_allclose(got, a @ X, rtol=1e-12, atol=1e-12)


def test_dirac_spd():
    a = dirac_scipy(3, m=0.5).toarray()
    np.testing.assert_allclose(a, a.T, atol=1e-14)
    evals = np.linalg.eigvalsh(a)
    assert evals.min() >= 0.5**2 - 1e-10  # block-Gershgorin bound m^2


def test_bsr_from_scipy_roundtrip():
    rng = np.random.default_rng(2)
    # random block-sparse SPD-ish matrix
    dense = sp.random(16, 16, density=0.3, random_state=3).toarray()
    dense = dense + dense.T + 8 * np.eye(16)
    a = sp.csr_matrix(dense)
    op = BSROperator.from_scipy(a, bs=4, dtype=jnp.float64)
    X = rng.standard_normal((16, 5))
    np.testing.assert_allclose(
        np.asarray(op(jnp.asarray(X))), dense @ X, rtol=1e-12, atol=1e-12
    )


def test_csr_ell_random_matrix():
    rng = np.random.default_rng(4)
    a = sp.random(37, 37, density=0.2, random_state=5, format="csr")
    X = rng.standard_normal((37, 4))
    want = a @ X
    for op in (
        CSROperator.from_scipy(a, dtype=jnp.float64),
        ELLOperator.from_scipy(a, dtype=jnp.float64),
    ):
        np.testing.assert_allclose(
            np.asarray(op(jnp.asarray(X))), want, rtol=1e-12, atol=1e-12
        )


def test_random_regular_spd():
    """Exact-regular expander generator: d off-diagonals per row (up to the
    rare self-loop/duplicate collision), SPD, symmetric."""
    import numpy as np
    from blockcg.problems import random_regular_spd

    a = random_regular_spd(512, degree=8, seed=3)
    assert (abs(a - a.T) > 0).nnz == 0
    offdiag = a.nnz - 512
    deg = offdiag / 512
    assert 7.0 <= deg <= 8.0  # permutation collisions shave a few edges
    # diagonally dominant by construction -> SPD
    d = a.diagonal()
    row_abs = np.abs(a).sum(axis=1).A1 - np.abs(d)
    assert (d >= row_abs).all()
