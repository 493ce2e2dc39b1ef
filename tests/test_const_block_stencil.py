"""ConstBlockDIA operator tests: the public applies on the flat, 3D and
merged spin-major views against scipy float64 oracles."""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.problems import bdia_scipy, dirac_bdia, dirac_cbdia


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_cbdia_matches_bdia_matrix(bc):
    """dirac_cbdia and dirac_bdia build the identical matrix."""
    L = 3
    a = bdia_scipy(dirac_cbdia(L, m=0.5, bc=bc, dtype=jnp.float64).to_block_dia())
    b = bdia_scipy(dirac_bdia(L, m=0.5, bc=bc, dtype=jnp.float64))
    assert abs((a - b)).max() < 1e-14


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_cbdia_xla_matches_scipy(bc):
    L = 4
    op = dirac_cbdia(L, m=0.5, bc=bc, dtype=jnp.float64)
    a = bdia_scipy(op.to_block_dia())
    rng = np.random.default_rng(0)
    X = rng.standard_normal((op.n, 3))
    got = np.asarray(op.matmat_t(jnp.asarray(X.T))).T
    np.testing.assert_allclose(got, a @ X, rtol=1e-12, atol=1e-12)


def test_cbdia_nnz_matches_bdia():
    for bc in ("periodic", "open"):
        assert (
            dirac_cbdia(4, bc=bc).nnz == dirac_bdia(4, bc=bc).nnz
        )


@pytest.mark.parametrize(
    "bc,L,k", [("periodic", 4, 6), ("open", 4, 2), ("periodic", 8, 3)]
)
def test_const_block_stencil_kernel_interpret(bc, L, k):
    op = dirac_cbdia(L, m=0.5, bc=bc, dtype=jnp.float32)
    a = bdia_scipy(op.to_block_dia())
    rng = np.random.default_rng(1)
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Xv = jnp.asarray(X.T).reshape(k, op.bs, op.ns)  # the 3D (k, bs, ns) view
    Yt = op.matmat_t(Xv).reshape(k, op.n)
    want = a @ X
    err = np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max()
    assert err < 1e-5


def test_const_kernel_no_masks_interpret():
    """All-unmasked operator (masks=None): pure torus vs dense oracle."""
    from blockcg.operators.cbdia import ConstBlockDIAOperator

    ns, bs, k = 256, 2, 3
    hops = (
        ((4.0, 0.5), (0.5, 4.0)),
        ((-1.0, 0.25), (0.0, -1.0)),
        ((-1.0, 0.0), (0.25, -1.0)),
    )
    op = ConstBlockDIAOperator(
        masks=None, hops=hops, offsets=(0, 1, -1), mask_slot=(-1, -1, -1),
        num_sites=ns,
    )
    rng = np.random.default_rng(2)
    Xt = jnp.asarray(rng.standard_normal((k, op.n)), dtype=jnp.float32)
    a = bdia_scipy(op.to_block_dia()).toarray()
    want = (a @ np.asarray(Xt, np.float64).T).T
    got = op.matmat_t(Xt)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-6, atol=2e-6)


def test_cbdia_solve_sbcgrq():
    """End-to-end: SBCGrQ through the const operator."""
    import blockcg as bc

    op = dirac_cbdia(4, m=0.5, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-5, max_iter=200)
    a = bdia_scipy(op.to_block_dia())
    r = np.asarray(B) - a @ np.asarray(X)
    rel = np.linalg.norm(r, axis=0) / np.linalg.norm(np.asarray(B), axis=0)
    assert rel.max() < 1e-4


def test_const_block_stencil_gram_fused():
    """Flat-view matmat_gram_t: Y as matmat_t, G == X Y^T."""
    op = dirac_cbdia(4, m=0.5, bc="periodic", dtype=jnp.float32)
    rng = np.random.default_rng(11)
    Xt = jnp.asarray(rng.standard_normal((5, op.n)), dtype=jnp.float32)
    Yt, G = op.matmat_gram_t(Xt)
    want_y = op.matmat_t(Xt)
    np.testing.assert_allclose(np.asarray(Yt), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)
    want_g = np.asarray(Xt, np.float64) @ np.asarray(want_y, np.float64).T
    np.testing.assert_allclose(np.asarray(G), want_g, rtol=1e-4, atol=1e-3)


def test_cbdia_matmat_gram_with_slabs():
    """Gram of a periodic L=8 operator, whose wrap diagonals touch only
    boundary slabs of sites, against scipy: the merged-view Gram contracts
    to the k x k X Y^T of the flat fields."""
    op = dirac_cbdia(8, m=0.5, bc="periodic", dtype=jnp.float32)
    a = bdia_scipy(op.to_block_dia())
    rng = np.random.default_rng(12)
    Xt = jnp.asarray(rng.standard_normal((4, op.n)), dtype=jnp.float32)
    Ym, G = op.matmat_gram_t(op.to_internal(Xt))
    Y = op.from_internal(Ym)
    want_y = (a @ np.asarray(Xt, np.float64).T).T
    np.testing.assert_allclose(np.asarray(Y), want_y, rtol=1e-5, atol=1e-5)
    want_g = np.asarray(Xt, np.float64) @ np.asarray(want_y, np.float64).T
    np.testing.assert_allclose(np.asarray(G), want_g, rtol=1e-4, atol=1e-3)


def test_cbdia_matmat_gram_odd_k_falls_back():
    """Odd k (m = bs*k = 12): the Gram is still returned, k x k."""
    op = dirac_cbdia(4, m=0.5, bc="periodic", dtype=jnp.float32)
    rng = np.random.default_rng(13)
    Xt = jnp.asarray(rng.standard_normal((3, op.n)), dtype=jnp.float32)
    Y, G = op.matmat_gram_t(Xt)
    want_y = op.matmat_t(Xt)
    np.testing.assert_allclose(np.asarray(Y), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    want_g = np.asarray(Xt, np.float64) @ np.asarray(want_y, np.float64).T
    np.testing.assert_allclose(np.asarray(G), want_g, rtol=1e-4, atol=1e-3)


def test_cbdia_merged_kernel_matches_scipy():
    """Merged spin-major apply vs the scipy oracle through the operator."""
    op = dirac_cbdia(4, m=0.5, bc="periodic", dtype=jnp.float32)
    a = bdia_scipy(op.to_block_dia())
    rng = np.random.default_rng(14)
    k = 2  # m = 8
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Xm = op.to_internal(jnp.asarray(X.T))
    assert Xm.shape == (op.bs * k, op.ns)
    Ym = op.matmat_t(Xm)
    Yt = op.from_internal(Ym)
    want = a @ X
    err = np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max()
    assert err < 1e-5


def test_cbdia_k1_merged_uses_legacy_kernel():
    """k=1 (the CG path): the merged (bs, ns) view equals the flat apply."""
    op = dirac_cbdia(4, m=0.5, bc="periodic", dtype=jnp.float32)
    rng = np.random.default_rng(15)
    Xm = jnp.asarray(rng.standard_normal((op.bs, op.ns)), dtype=jnp.float32)
    got = op.matmat_t(Xm)
    want = op.to_internal(op.matmat_t(op.from_internal(Xm)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    a = bdia_scipy(op.to_block_dia())
    want_np = a @ np.asarray(op.from_internal(Xm), np.float64)[0]
    np.testing.assert_allclose(np.asarray(op.from_internal(got))[0], want_np,
                               rtol=1e-5, atol=1e-5)
