"""BlockDIA merged-view apply at L = 8 (T-K1 matrix-link path): several
toroidal wraps per axis, t-offsets that reach far across the site axis, and
site-varying matrix links, through the operator's public ``matmat_t`` /
``matmat_gram_t`` against scipy float64 assemblies.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.problems import bdia_scipy, dirac_bdia, dirac_gauged_matrix


def _merged(op, X):
    """(n, k) column block -> merged spin-major (m, ns) view."""
    return op.to_internal(jnp.asarray(X.T))


@pytest.mark.parametrize("bc,k", [("periodic", 2), ("open", 2),
                                  ("periodic", 4)])
def test_ring_block_matches_scipy(bc, k):
    L = 8  # ns = 4096; the t-offset 512 wraps the site axis
    op = dirac_bdia(L, m=0.5, bc=bc, dtype=jnp.float32)
    a = bdia_scipy(op)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Ym = op.matmat_t(_merged(op, X))
    got = np.asarray(op.from_internal(Ym)).T
    want = a @ X
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_ring_block_matrix_links_matches_scipy():
    """The genuine matrix-link (per-site orthogonal U) subject."""
    op = dirac_gauged_matrix(8, m=0.5, dtype=jnp.float32)
    a = bdia_scipy(op)
    rng = np.random.default_rng(1)
    k = 2
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Ym = op.matmat_t(_merged(op, X))
    got = np.asarray(op.from_internal(Ym)).T
    want = a @ X
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_ring_block_gram_and_seed():
    """matmat_gram_t on the merged view: Y equals the plain apply and G the
    k x k contraction of X Y^T."""
    op = dirac_bdia(8, m=0.5, bc="periodic", dtype=jnp.float32)
    rng = np.random.default_rng(2)
    k = 2
    m = op.bs * k
    Xm = jnp.asarray(rng.standard_normal((m, op.ns)), jnp.float32)
    Y0 = op.matmat_t(Xm)
    Y, G = op.matmat_gram_t(Xm)
    np.testing.assert_allclose(np.asarray(Y), np.asarray(Y0),
                               rtol=1e-6, atol=1e-6)
    wantG = np.asarray(Xm, np.float64) @ np.asarray(Y0, np.float64).T
    wantG = np.einsum("aiaj->ij", wantG.reshape(op.bs, k, op.bs, k))
    assert np.abs(np.asarray(G, np.float64) - wantG).max() / np.abs(
        wantG).max() < 1e-5


def test_ring_block_bf16_accumulates_f32():
    """bf16 blocks and field: the apply accumulates in f32 and stores bf16."""
    op = dirac_bdia(8, m=0.5, bc="periodic", dtype=jnp.float32)
    rng = np.random.default_rng(3)
    Xm = jnp.asarray(rng.standard_normal((8, op.ns)), jnp.float32)
    want = op.matmat_t(Xm)
    opb = type(op)(blocks=op.blocks.astype(jnp.bfloat16), offsets=op.offsets)
    Yb = opb.matmat_t(Xm.astype(jnp.bfloat16))
    assert Yb.dtype == jnp.bfloat16
    ref = np.asarray(want, np.float64)
    # bf16 stores ~8e-3 relative; accumulation stays f32
    assert np.abs(np.asarray(Yb, np.float64) - ref).max() / np.abs(
        ref).max() < 5e-2


def test_ring_block_onchip_smoke():
    """Open-boundary operator: apply and gram vs the scipy oracle on the
    merged view (chip_smoke.py runs the same comparison on the GPU)."""
    op = dirac_bdia(8, m=0.5, bc="open", dtype=jnp.float32)
    a = bdia_scipy(op)
    rng = np.random.default_rng(5)
    k = 2
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    want = a @ X
    Ym, G = op.matmat_gram_t(_merged(op, X))
    got = np.asarray(op.from_internal(Ym)).T
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    wantG = X.T.astype(np.float64) @ want.astype(np.float64)
    assert np.abs(np.asarray(G, np.float64) - wantG).max() / np.abs(
        wantG).max() < 1e-5
