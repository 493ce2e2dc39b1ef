"""Sparse-tile operator + native tilizer tests (general CSR path)."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp

from blockcg.native import have_native, tilize_csr
from blockcg.operators import TiledOperator
from blockcg.problems import laplacian_scipy, random_block


def _random_sparse_spd(n, density, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    a = a + a.T + sp.eye(n) * (abs(a).sum(axis=1).max() + 1.0)
    return sp.csr_matrix(a)


def test_native_tilizer_matches_numpy():
    a = _random_sparse_spd(500, 0.02, 0)
    out_np = tilize_csr(a, 128, force_numpy=True)
    if not have_native():
        pytest.skip("no g++ available")
    out_cc = tilize_csr(a, 128, force_numpy=False)
    for x, y in zip(out_cc, out_np):
        np.testing.assert_array_equal(x, y)


def test_tilizer_reconstructs_matrix():
    a = _random_sparse_spd(384, 0.05, 1)
    tiles, rt, ct, first = tilize_csr(a, 128)
    dense = np.zeros((384, 384), np.float32)
    for t, r, c in zip(tiles, rt, ct):
        dense[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] += t
    np.testing.assert_allclose(dense, a.toarray(), rtol=1e-6, atol=1e-6)
    # sorted by row tile, exactly one `first` per row tile
    assert (np.diff(rt) >= 0).all()
    assert first.sum() == len(np.unique(rt))


@pytest.mark.parametrize("n,density,k", [(384, 0.03, 5), (640, 0.01, 3)])
def test_tiled_operator_xla_matches_scipy(n, density, k):
    a = _random_sparse_spd(n, density, 2)
    op = TiledOperator.from_scipy(a, dtype=jnp.float64)
    X = random_block(op.n, k, seed=3)
    got = np.asarray(op.matmat(jnp.asarray(X)))
    want = sp.block_diag([a, sp.eye(op.n - n)]) @ X if op.n != n else a @ X
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_tiled_kernel_interpret_matches_scipy():
    """f32 lanes-major apply (tile gather + batched dot + segment sum)."""
    a = _random_sparse_spd(512, 0.02, 4)
    op = TiledOperator.from_scipy(a, dtype=jnp.float32)
    X = random_block(512, 4, seed=5).astype(np.float32)
    Yt = op.matmat_t(jnp.asarray(X.T))
    want = a @ X
    err = np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max()
    assert err < 1e-5


def test_tiled_padding_path():
    """n not a multiple of 128: padded with identity, solves still work."""
    a = _random_sparse_spd(200, 0.05, 6)
    op = TiledOperator.from_scipy(a, dtype=jnp.float64)
    assert op.n == 256
    X = random_block(256, 2, seed=7)
    got = np.asarray(op.matmat(jnp.asarray(X)))
    full = sp.block_diag([a, sp.eye(56)])
    np.testing.assert_allclose(got, full @ X, rtol=1e-10, atol=1e-10)


def test_solver_through_tiled_operator():
    from blockcg import solve_sbcgrq

    a = laplacian_scipy((20, 20))  # n=400 -> padded to 512
    op = TiledOperator.from_scipy(a, dtype=jnp.float64)
    B = np.zeros((op.n, 4))
    B[:400] = random_block(400, 4, seed=8)
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-10, max_iter=400)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X)[:400] - B[:400], axis=0)
    res /= np.linalg.norm(B[:400], axis=0)
    assert res.max() <= 1e-9


def test_tiled_rcm_reorder_matches_scipy():
    """RCM reordering (T-K1 scattered path): apply in permuted order through
    the order-conversion helpers reproduces the original matrix action, and
    tile fill improves by an order of magnitude on an unstructured mesh."""
    from blockcg.problems import delaunay_laplacian

    a = delaunay_laplacian(3000, seed=0)
    plain = TiledOperator.from_scipy(a, dtype=jnp.float64,
                                     max_pad_bytes=16 << 30)
    op = TiledOperator.from_scipy(a, dtype=jnp.float64, reorder="rcm")
    assert op.fill > 5 * plain.fill
    X = random_block(3000, 3, seed=1)
    got = op.from_solver_order(op.matmat(op.to_solver_order(jnp.asarray(X))))
    np.testing.assert_allclose(np.asarray(got), a @ X, rtol=1e-10, atol=1e-10)


def test_tiled_bf16_storage():
    """bf16 tile storage: both apply directions agree with the f64 oracle
    to bf16 matrix-rounding accuracy; solver dtype stays f32."""
    a = _random_sparse_spd(512, 0.02, 9)
    op = TiledOperator.from_scipy(a, dtype=jnp.float32,
                                  tile_dtype=jnp.bfloat16)
    assert op.tiles.dtype == jnp.bfloat16
    assert op.dtype == jnp.float32
    X = random_block(512, 4, seed=10).astype(np.float32)
    want = a @ X
    got = np.asarray(op.matmat(jnp.asarray(X)))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-2  # bf16 has ~8 mantissa bits
    Yt = op.matmat_t(jnp.asarray(X.T))
    rel_k = np.abs(np.asarray(Yt).T - want).max() / np.abs(want).max()
    assert rel_k < 2e-2


def test_tiled_rcm_bf16_refined_to_1e10():
    """The full scattered-sparsity story: RCM + bf16 tiles for bandwidth,
    mixed-precision refinement (f64 CSR outer operator) restores 1e-10 —
    the same refinement contract as the f32-matrix case (T-C5)."""
    from blockcg import solve_refined
    from blockcg.operators import CSROperator
    from blockcg.problems import delaunay_laplacian

    a = delaunay_laplacian(2000, seed=2)
    op = TiledOperator.from_scipy(a, dtype=jnp.float32, reorder="rcm",
                                  tile_dtype=jnp.bfloat16)
    op64 = CSROperator.from_scipy(op.reordered_scipy(a), dtype=jnp.float64)
    # f32 RHS (exactly representable) so the true-residual check isn't
    # floored by RHS rounding.
    B = random_block(2000, 4, seed=3).astype(np.float32)
    Bp = op.to_solver_order(jnp.asarray(B))
    X, info = solve_refined(op, Bp, tol=1e-10, inner_tol=1e-3, op64=op64,
                            max_cycles=12)
    assert bool(info.converged.all())
    Xo = np.asarray(op.from_solver_order(X), np.float64)
    res = np.linalg.norm(a @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10
