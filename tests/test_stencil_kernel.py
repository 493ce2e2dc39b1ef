"""DIA stencil apply tests (T-K1): the operator's public ``matmat_t`` /
``matmat_gram_t`` against scipy and dense float64 oracles. chip_smoke.py
runs the same apply on the GPU at full width.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp

from blockcg.operators import DIAOperator
from blockcg.problems import laplacian_dia, laplacian_scipy


def _dense_oracle(diags, offsets, Xt):
    """Toroidal DIA apply in float64: Y[:, i] = sum_d c_d[i] X[:, i+o_d]."""
    D = np.asarray(diags, np.float64)
    X = np.asarray(Xt, np.float64)
    n = D.shape[1]
    Y = np.zeros_like(X)
    for d, o in enumerate(offsets):
        Y += D[d][None, :] * X[:, (np.arange(n) + o) % n]
    return Y


@pytest.mark.parametrize("shape,k", [((16, 16, 16), 8), ((64, 64), 4), ((32, 32), 1)])
def test_stencil_matches_scipy_laplacian(shape, k):
    op = laplacian_dia(shape, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Yt = op.matmat_t(jnp.asarray(X.T))
    want = laplacian_scipy(shape) @ X
    err = np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max()
    assert err < 1e-5


def test_stencil_random_banded():
    """Random banded matrix with ragged offsets (not just Laplacians)."""
    n = 1024
    rng = np.random.default_rng(1)
    offsets = [-130, -7, -1, 0, 2, 64, 257]
    data = []
    for o in offsets:
        d = np.zeros(n)
        m = n - abs(o)
        d[:m] = rng.standard_normal(m)
        data.append(d)
    a = sp.diags(
        [d[: n - abs(o)] for d, o in zip(data, offsets)], offsets, shape=(n, n)
    ).tocsr()
    op = DIAOperator.from_scipy(a, dtype=jnp.float32)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    Yt = op.matmat_t(jnp.asarray(X.T))
    want = a @ X
    assert np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max() < 1e-5


def test_stencil_agrees_with_xla_path():
    """Lanes-major apply == the public (n, k) matmat and the dense oracle."""
    op = laplacian_dia((8, 8, 8), dtype=jnp.float32)
    rng = np.random.default_rng(2)
    Xt = jnp.asarray(rng.standard_normal((6, op.n)), dtype=jnp.float32)
    got = op.matmat_t(Xt)
    np.testing.assert_allclose(np.asarray(got), np.asarray(op.matmat(Xt.T)).T,
                               rtol=1e-6, atol=1e-6)
    want = _dense_oracle(op.diags, op.offsets, Xt)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_stencil_far_window_correctness():
    """Large strides relative to n (n/4 offsets) against scipy."""
    import scipy.sparse as sp

    n = 4096
    rng = np.random.default_rng(3)
    offsets = [-1024, -1, 0, 1, 1024]
    data = []
    for o in offsets:
        d = np.zeros(n)
        d[: n - abs(o)] = rng.standard_normal(n - abs(o))
        data.append(d)
    a = sp.diags(
        [d[: n - abs(o)] for d, o in zip(data, offsets)], offsets, shape=(n, n)
    ).tocsr()
    op = DIAOperator.from_scipy(a, dtype=jnp.float32)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    Yt = op.matmat_t(jnp.asarray(X.T))
    want = a @ X
    assert np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max() < 1e-5


def test_stencil_gram_fused():
    """matmat_gram_t: Y matches the plain apply, G == X Y^T."""
    op = laplacian_dia((16, 16, 16), dtype=jnp.float32)
    rng = np.random.default_rng(7)
    Xt = jnp.asarray(rng.standard_normal((8, op.n)), dtype=jnp.float32)
    Yt, G = op.matmat_gram_t(Xt)
    want_y = op.matmat_t(Xt)
    np.testing.assert_allclose(np.asarray(Yt), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)
    want_g = np.asarray(Xt, np.float64) @ np.asarray(want_y, np.float64).T
    np.testing.assert_allclose(np.asarray(G), want_g, rtol=1e-4, atol=1e-3)


def test_dia_matmat_gram_fallback_none():
    """matmat_gram_t always returns the k x k Gram (never None): solvers
    psum it as it comes (solvers/common.f_matmat_gram)."""
    op = laplacian_dia((32, 32), dtype=jnp.float32)
    rng = np.random.default_rng(8)
    Xt = jnp.asarray(rng.standard_normal((4, op.n)), dtype=jnp.float32)
    Y, G = op.matmat_gram_t(Xt)
    assert G is not None and G.shape == (4, 4)
    np.testing.assert_allclose(np.asarray(Y), np.asarray(op.matmat_t(Xt)),
                               rtol=1e-6, atol=1e-6)
    want_g = np.asarray(Xt, np.float64) @ np.asarray(Y, np.float64).T
    np.testing.assert_allclose(np.asarray(G), want_g, rtol=1e-5, atol=1e-3)


def test_stencil_duplicate_offsets():
    """Duplicate offsets are summed, each diagonal applied once."""
    rng = np.random.default_rng(52)
    n, k = 256, 8
    diags = rng.standard_normal((3, n)).astype(np.float32)
    offsets = (0, 1, 1)
    op = DIAOperator(diags=jnp.asarray(diags), offsets=offsets)
    Xt = jnp.asarray(rng.standard_normal((k, n)), jnp.float32)
    got = op.matmat_t(Xt)
    want = _dense_oracle(diags, offsets, Xt)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)
