"""Tests that need the GPU (marker ``gpu``; they skip elsewhere).

chip_smoke.py runs them on the card, in its own process, after its phases:
``python chip_smoke.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import blockcg as bc
from blockcg.problems import laplacian_dia, laplacian_scipy

pytestmark = pytest.mark.gpu


def _relres(a, X, B):
    X = np.asarray(X).astype(np.float64)
    B = np.asarray(B).astype(np.float64)
    return (np.linalg.norm(B - a @ X, axis=0)
            / np.linalg.norm(B, axis=0)).max()


def test_solve_runs_on_the_gpu():
    """A solve's operator, RHS and result all live on the GPU."""
    dev = jax.devices()[0]
    assert dev.platform == "gpu"
    op = laplacian_dia((32, 32, 32), dtype=jnp.float32)
    B = jnp.asarray(np.random.default_rng(0).standard_normal((op.n, 16)),
                    jnp.float32)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=500)
    for arr in (op.diags, B, X):
        assert arr.devices() == {dev}
    assert bool(info.converged.all())
    assert _relres(laplacian_scipy((32, 32, 32)), X, B) <= 1e-5


def test_f32_products_are_not_tf32():
    """The library's k x k-times-field and Gram products keep f32
    precision on the card (TF32 would leave ~1e-3 relative error)."""
    from blockcg.solvers.common import gram_t, mm

    rng = np.random.default_rng(1)
    M = jnp.asarray(rng.standard_normal((32, 32)), jnp.float32)
    F = jnp.asarray(rng.standard_normal((32, 1 << 16)), jnp.float32)
    want = np.asarray(M, np.float64) @ np.asarray(F, np.float64)
    got = np.asarray(mm(M, F), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    G = np.asarray(gram_t(F, F), np.float64)
    Fd = np.asarray(F, np.float64)
    assert np.abs(G - Fd @ Fd.T).max() / np.abs(Fd @ Fd.T).max() < 1e-5


def test_refined_outer_is_native_float64():
    """solve_refined's outer step runs in float64 on the card and reaches
    1e-10 true relative residual."""
    shape = (24, 24, 24)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(np.random.default_rng(2).standard_normal((op.n, 8)),
                    jnp.float32)
    X, info = bc.solve_refined(op, B, tol=1e-10)
    assert X.dtype == jnp.float64
    assert X.devices() == {jax.devices()[0]}
    assert _relres(laplacian_scipy(shape), X, B) <= 1e-10


def test_complex_solve_native_on_gpu():
    """complex64 Hermitian solve with no host round trip."""
    from blockcg.problems import bdia_scipy, dirac_gauged

    dev = jax.devices()[0]
    op = dirac_gauged(6, dtype=jnp.complex64)
    rng = np.random.default_rng(3)
    B = jnp.asarray(rng.standard_normal((op.n, 4))
                    + 1j * rng.standard_normal((op.n, 4)), jnp.complex64)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=500)
    assert op.blocks.devices() == {dev} and X.devices() == {dev}
    a = bdia_scipy(op)
    R = np.asarray(B, np.complex128) - a @ np.asarray(X, np.complex128)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.complex128), axis=0)).max()
    assert rel <= 1e-5
