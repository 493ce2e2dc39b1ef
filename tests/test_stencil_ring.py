"""DIA apply at large offsets and toroidal wraps (T-K1): the operator's
public ``matmat_t`` / ``matmat_gram_t`` against dense float64 toroidal
oracles, including far offsets with nonzero residues and bf16 storage.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.operators import DIAOperator
from blockcg.problems import laplacian_dia, laplacian_scipy


def _oracle(diags, offsets, Xt):
    ndiag, n = np.asarray(diags).shape
    X = np.asarray(Xt, np.float64)
    D = np.asarray(diags, np.float64)
    Y = np.zeros_like(X)
    for d, o in enumerate(offsets):
        Y += D[d][None, :] * X[:, (np.arange(n) + o) % n]
    return Y


@pytest.mark.parametrize("n,k,offsets", [
    (4096, 8, (0, 1, -1, 128, -128, 1024, -1024)),   # 3D-like near+far
    (8192, 16, (0, 2048, -2048)),                    # exact-far only, H=0
    (4096, 8, (0, 1100, -1100, 3, -3)),              # far with residual r!=0
    (4096, 8, (0, 980, -980)),                       # negative residual
    (16384, 12, (0, 1, -1, 128, -128, 2048, -2048)),
])
def test_ring_matches_oracle(n, k, offsets):
    rng = np.random.default_rng(0)
    diags = jnp.asarray(rng.standard_normal((len(offsets), n)), jnp.float32)
    Xt = jnp.asarray(rng.standard_normal((k, n)), jnp.float32)
    Y = DIAOperator(diags=diags, offsets=offsets).matmat_t(Xt)
    ref = _oracle(diags, offsets, Xt)
    assert np.abs(np.asarray(Y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30) < 1e-5


def test_ring_gram_fused():
    n, k = 4096, 8
    offsets = (0, 1, -1, 128, -128, 1024, -1024)
    rng = np.random.default_rng(1)
    diags = jnp.asarray(rng.standard_normal((len(offsets), n)), jnp.float32)
    Xt = jnp.asarray(rng.standard_normal((k, n)), jnp.float32)
    Y, G = DIAOperator(diags=diags, offsets=offsets).matmat_gram_t(Xt)
    ref = _oracle(diags, offsets, Xt)
    refG = np.asarray(Xt, np.float64) @ ref.T
    assert np.abs(np.asarray(Y, np.float64) - ref).max() / np.abs(
        ref).max() < 1e-5
    assert np.abs(np.asarray(G, np.float64) - refG).max() / np.abs(
        refG).max() < 1e-5


def test_ring_matches_laplacian_scipy():
    """Dirichlet Laplacian: wrap coefficients are zero by construction, so
    the toroidal semantics equal the truncated scipy apply."""
    shape = (16, 16, 16)
    op = laplacian_dia(shape, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((op.n, 8)).astype(np.float32)
    Yt = op.matmat_t(jnp.asarray(X.T))
    want = laplacian_scipy(shape) @ X
    assert np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max() < 1e-5


def test_ring_bf16_accumulates_f32():
    n, k = 8192, 8
    offsets = (0, 1, -1, 128, -128, 2048, -2048)
    rng = np.random.default_rng(3)
    diags = jnp.asarray(rng.standard_normal((len(offsets), n)), jnp.bfloat16)
    Xt = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    Y = DIAOperator(diags=diags, offsets=offsets).matmat_t(Xt)
    assert Y.dtype == jnp.bfloat16
    ref = _oracle(diags, offsets, Xt)  # oracle of the ROUNDED inputs
    # bf16 stores: ~8e-3 relative; accumulation is f32 so error does not
    # scale with ndiag
    assert np.abs(np.asarray(Y, np.float64) - ref).max() / np.abs(
        ref).max() < 3e-2
