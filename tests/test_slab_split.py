"""Periodic wrap diagonals of the const-hop operator: at L = 16 the z- and
y-wraps couple only boundary slabs of sites, far across the site axis."""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.problems import bdia_scipy, dirac_cbdia


@pytest.mark.parametrize("L,k", [(16, 3)])
def test_slab_kernel_matches_oracle(L, k):
    """Periodic L=16 apply (wrap diagonals included) vs scipy."""
    op = dirac_cbdia(L, m=0.5, bc="periodic", dtype=jnp.float32)
    assert (L - 1) * L * L in op.offsets  # the z-wrap diagonal is present
    a = bdia_scipy(op.to_block_dia())
    rng = np.random.default_rng(0)
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Yt = op.matmat_t(jnp.asarray(X.T))
    want = a @ X
    err = np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max()
    assert err < 1e-5


def test_slab_solve_end_to_end():
    import blockcg as bc

    op = dirac_cbdia(16, m=0.5, bc="periodic", dtype=jnp.float32)
    rng = np.random.default_rng(1)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-5, max_iter=200)
    a = bdia_scipy(op.to_block_dia())
    r = np.asarray(B) - a @ np.asarray(X)
    assert (np.linalg.norm(r, axis=0) / np.linalg.norm(np.asarray(B), axis=0)).max() < 1e-4
