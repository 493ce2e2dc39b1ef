"""BlockDIA operator tests (T-K1 block flavor): the public applies on the
flat, 3D and merged spin-major views against scipy float64 oracles."""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.problems import bdia_scipy, dirac_bdia, dirac_scipy


def _dense_bdia(blocks, offsets):
    """Toroidal BlockDIA matrix in float64, spin-major rows a*ns + s."""
    noff, bs, _, ns = blocks.shape
    a = np.zeros((bs * ns, bs * ns))
    s = np.arange(ns)
    for d, o in enumerate(offsets):
        cols = (s + o) % ns
        for i in range(bs):
            for j in range(bs):
                a[i * ns + s, j * ns + cols] += np.asarray(
                    blocks[d, i, j], np.float64)
    return a


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_bdia_xla_matches_scipy(bc):
    L = 4
    op = dirac_bdia(L, m=0.5, bc=bc, dtype=jnp.float64)
    a = bdia_scipy(op)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((op.n, 3))
    got = np.asarray(op.matmat_t(jnp.asarray(X.T))).T
    np.testing.assert_allclose(got, a @ X, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_bdia_spd_and_symmetric(bc):
    a = bdia_scipy(dirac_bdia(3, m=0.5, bc=bc, dtype=jnp.float64)).toarray()
    np.testing.assert_allclose(a, a.T, atol=1e-14)
    assert np.linalg.eigvalsh(a).min() >= 0.5**2 - 1e-10


def test_bdia_matches_bsr_form():
    """Spin-major BDIA and site-major BSR describe the same matrix up to the
    row/col permutation perm(a*ns+s) = s*4+a."""
    L = 3
    a_bdia = bdia_scipy(dirac_bdia(L, m=0.5, bc="periodic", dtype=jnp.float64))
    a_bsr = dirac_scipy(L, m=0.5, bc="periodic")
    ns = L**4
    s = np.arange(ns)
    perm = np.concatenate([s * 4 + a for a in range(4)])  # spin-major -> site-major
    got = a_bsr[perm][:, perm]
    diff = (a_bdia - got).toarray()
    assert np.abs(diff).max() < 1e-14


@pytest.mark.parametrize("bc,L,k", [("periodic", 4, 6), ("open", 4, 2), ("periodic", 8, 3)])
def test_block_stencil_kernel_interpret(bc, L, k):
    op = dirac_bdia(L, m=0.5, bc=bc, dtype=jnp.float32)
    a = bdia_scipy(op)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Xv = jnp.asarray(X.T).reshape(k, op.bs, op.ns)  # the 3D (k, bs, ns) view
    Yt = op.matmat_t(Xv).reshape(k, op.n)
    want = a @ X
    err = np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max()
    assert err < 1e-5


def test_block_stencil_merged_kernel_matches_scipy():
    """Merged spin-major general apply vs scipy, through the operator."""
    from blockcg.problems import dirac_gauged
    from blockcg.problems.dirac import bdia_scipy

    op = dirac_gauged(4, m=0.5, dtype=jnp.float32)
    a = bdia_scipy(op)
    rng = np.random.default_rng(17)
    k = 2  # m = 8
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Xm = op.to_internal(jnp.asarray(X.T))
    assert Xm.shape == (op.bs * k, op.ns)
    Ym = op.matmat_t(Xm)
    Yt = np.asarray(op.from_internal(Ym)).T
    want = a @ X
    assert np.abs(Yt - want).max() / np.abs(want).max() < 1e-5


def test_block_stencil_merged_gram():
    """matmat_gram_t on the merged view: Y as the plain apply, G the k x k
    contraction of the merged (m, m) Gram."""
    from blockcg.problems import dirac_gauged

    op = dirac_gauged(4, m=0.5, dtype=jnp.float32)
    rng = np.random.default_rng(18)
    k = 2
    Xm = jnp.asarray(rng.standard_normal((op.bs * k, op.ns)), jnp.float32)
    Ym, G = op.matmat_gram_t(Xm)
    want_y = op.matmat_t(Xm)
    np.testing.assert_allclose(np.asarray(Ym), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)
    want_g = np.asarray(Xm, np.float64) @ np.asarray(want_y, np.float64).T
    want_g = np.einsum("aiaj->ij", want_g.reshape(op.bs, k, op.bs, k))
    assert G.shape == (k, k)
    np.testing.assert_allclose(np.asarray(G), want_g, rtol=1e-4, atol=1e-3)


def test_block_stencil_duplicate_offsets():
    """Duplicate offsets are summed on both the 3D and the merged view."""
    from blockcg.operators.bdia import BlockDIAOperator

    rng = np.random.default_rng(53)
    n = 256
    blocks = rng.standard_normal((3, 2, 2, n)).astype(np.float32)
    offsets = (0, 1, 1)
    bop = BlockDIAOperator(blocks=jnp.asarray(blocks), offsets=offsets)
    a = _dense_bdia(blocks, offsets)
    Xv = jnp.asarray(rng.standard_normal((4, 2, n)), jnp.float32)
    got = bop.matmat_t(Xv)
    want = (a @ np.asarray(Xv, np.float64).reshape(4, 2 * n).T).T
    np.testing.assert_allclose(np.asarray(got).reshape(4, 2 * n), want,
                               rtol=1e-5, atol=1e-5)
    Xm = jnp.asarray(rng.standard_normal((8, n)), jnp.float32)
    got_m = bop.from_internal(bop.matmat_t(Xm))
    want_m = (a @ np.asarray(bop.from_internal(Xm), np.float64).T).T
    np.testing.assert_allclose(np.asarray(got_m), want_m,
                               rtol=1e-5, atol=1e-5)
