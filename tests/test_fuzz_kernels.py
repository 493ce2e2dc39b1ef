"""Property/fuzz tests: random structures through the operators' public
applies vs float64 dense oracles — exercises near/far offsets, toroidal
wraps, duplicate offsets and mask patterns beyond the hand-built problem
generators."""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.operators import DIAOperator
from blockcg.operators.bdia import BlockDIAOperator
from blockcg.operators.cbdia import ConstBlockDIAOperator


def _dense_from_diags(n, offsets, diags):
    a = np.zeros((n, n))
    s = np.arange(n)
    for d, o in enumerate(offsets):
        a[s, (s + o) % n] += diags[d]  # toroidal semantics
    return a


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_scalar_stencil(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([256, 512, 1024, 2048]))
    k = int(rng.integers(1, 9))
    noff = int(rng.integers(2, 9))
    offsets = set([0])
    while len(offsets) < noff:
        mag = int(rng.choice([1, 2, 3, 7, 16, 64, n // 4, n // 2]))
        offsets.add(int(rng.choice([-1, 1])) * mag)
    offsets = tuple(sorted(offsets))
    diags = rng.standard_normal((noff, n)).astype(np.float32)
    a = _dense_from_diags(n, offsets, diags.astype(np.float64))
    X = rng.standard_normal((n, k)).astype(np.float32)
    op = DIAOperator(diags=jnp.asarray(diags), offsets=offsets)
    Yt = op.matmat_t(jnp.asarray(X.T))
    want = a @ X
    denom = max(np.abs(want).max(), 1e-30)
    assert np.abs(np.asarray(Yt).T - want).max() / denom < 1e-5


def _dense_from_const_blocks(ns, bs, offsets, hops, mask_slot, masks):
    n = bs * ns
    a = np.zeros((n, n))
    s = np.arange(ns)
    for d, o in enumerate(offsets):
        m = np.ones(ns) if mask_slot[d] < 0 else masks[mask_slot[d]]
        h = np.asarray(hops[d])
        cols = (s + o) % ns
        for i in range(bs):
            for j in range(bs):
                a[i * ns + s, j * ns + cols] += h[i, j] * m
    return a


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_const_block_stencil(seed):
    rng = np.random.default_rng(100 + seed)
    ns = int(rng.choice([256, 512, 1024]))
    bs = int(rng.choice([2, 3, 4]))
    k = int(rng.integers(1, 7))
    noff = int(rng.integers(2, 7))
    offsets = set([0])
    while len(offsets) < noff:
        mag = int(rng.choice([1, 5, 32, ns // 4, ns // 2]))
        offsets.add(int(rng.choice([-1, 1])) * mag)
    offsets = tuple(sorted(offsets))
    hops, mask_slot, masks = [], [], []
    for d in range(len(offsets)):
        h = rng.standard_normal((bs, bs)).astype(np.float32)
        h[rng.random((bs, bs)) < 0.3] = 0.0  # exercise zero-entry skipping
        hops.append(tuple(tuple(float(v) for v in row) for row in h))
        if rng.random() < 0.5:
            mask_slot.append(len(masks))
            masks.append((rng.random(ns) < 0.7).astype(np.float32))
        else:
            mask_slot.append(-1)
    hops = tuple(hops)
    mask_slot = tuple(mask_slot)
    masks_j = jnp.asarray(np.stack(masks)) if masks else None
    op = ConstBlockDIAOperator(masks=masks_j, hops=hops, offsets=offsets,
                               mask_slot=mask_slot, num_sites=ns)
    X = rng.standard_normal((bs * ns, k)).astype(np.float32)
    Xv = jnp.asarray(X.T).reshape(k, bs, ns)
    Yv = op.matmat_t(Xv)  # the 3D (k, bs, ns) view
    a = _dense_from_const_blocks(ns, bs, offsets, hops, mask_slot, masks)
    want = a @ X
    got = np.asarray(Yv).reshape(k, bs * ns).T
    denom = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / denom < 1e-5


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_merged_const_block_stencil(seed):
    """Merged spin-major apply (+ gram) with random VALUE masks and
    duplicate offsets vs the dense oracle."""
    rng = np.random.default_rng(300 + seed)
    ns = int(rng.choice([256, 512, 1024]))
    bs = int(rng.choice([2, 4]))
    kcand = [kk for kk in range(1, 9) if (bs * kk) % 8 == 0]
    k = int(rng.choice(kcand))
    noff = int(rng.integers(2, 7))
    offs_pool = set([0])
    while len(offs_pool) < noff:
        mag = int(rng.choice([1, 5, 32, ns // 4, ns // 2]))
        offs_pool.add(int(rng.choice([-1, 1])) * mag)
    offsets, hops, mask_slot, masks = [], [], [], []
    for o in sorted(offs_pool):
        reps = 2 if (o != 0 and rng.random() < 0.3) else 1  # duplicates
        for _ in range(reps):
            h = rng.standard_normal((bs, bs)).astype(np.float32)
            h[rng.random((bs, bs)) < 0.3] = 0.0
            offsets.append(o)
            hops.append(tuple(tuple(float(v) for v in row) for row in h))
            if rng.random() < 0.7:
                mask_slot.append(len(masks))
                vals = rng.standard_normal(ns).astype(np.float32)
                vals[rng.random(ns) < 0.3] = 0.0  # value masks w/ zeros
                masks.append(vals)
            else:
                mask_slot.append(-1)
    offsets = tuple(offsets)
    hops = tuple(hops)
    mask_slot = tuple(mask_slot)
    m = bs * k
    masks_j = jnp.asarray(np.stack(masks)) if masks else None
    op = ConstBlockDIAOperator(masks=masks_j, hops=hops, offsets=offsets,
                               mask_slot=mask_slot, num_sites=ns)
    X = rng.standard_normal((bs * ns, k)).astype(np.float32)
    # merged spin-major rows: row = a*k + i from flat spin-major a*ns + s
    Xm = jnp.asarray(X.T).reshape(k, bs, ns).swapaxes(0, 1).reshape(m, ns)
    Ym = op.matmat_t(Xm)
    Y2, G = op.matmat_gram_t(Xm)
    a = _dense_from_const_blocks(ns, bs, offsets, hops, mask_slot, masks)
    want = a @ X
    got = np.asarray(Ym).reshape(bs, k, ns).swapaxes(0, 1).reshape(
        k, bs * ns).T
    denom = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / denom < 1e-5
    np.testing.assert_allclose(np.asarray(Y2), np.asarray(Ym),
                               rtol=1e-6, atol=1e-6)
    # the operator contracts the (m, m) Gram of the merged field to k x k
    want_g = (np.asarray(Xm, np.float64)
              @ np.asarray(Ym, np.float64).T)
    want_g = np.einsum("aiaj->ij", want_g.reshape(bs, k, bs, k))
    np.testing.assert_allclose(np.asarray(G), want_g, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_merged_general_block_stencil(seed):
    """Merged general (per-site blocks) apply vs the dense oracle."""
    rng = np.random.default_rng(400 + seed)
    ns = int(rng.choice([256, 512]))
    bs = int(rng.choice([2, 4]))
    kcand = [kk for kk in range(1, 7) if (bs * kk) % 8 == 0]
    k = int(rng.choice(kcand))
    noff = int(rng.integers(2, 6))
    offsets = set([0])
    while len(offsets) < noff:
        mag = int(rng.choice([1, 5, 32, ns // 4]))
        offsets.add(int(rng.choice([-1, 1])) * mag)
    offsets = tuple(sorted(offsets))
    blocks = rng.standard_normal((len(offsets), bs, bs, ns)).astype(np.float32)
    blocks[rng.random(blocks.shape) < 0.2] = 0.0
    op = BlockDIAOperator(blocks=jnp.asarray(blocks), offsets=offsets)
    X = rng.standard_normal((bs * ns, k)).astype(np.float32)
    Xm = op.to_internal(jnp.asarray(X.T))
    Ym = op.matmat_t(Xm)
    got = np.asarray(op.from_internal(Ym)).T
    # dense oracle
    n = bs * ns
    a = np.zeros((n, n))
    s = np.arange(ns)
    for d, o in enumerate(offsets):
        cols = (s + o) % ns
        for i in range(bs):
            for j in range(bs):
                a[i * ns + s, j * ns + cols] += blocks[d, i, j].astype(
                    np.float64)
    want = a @ X
    denom = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / denom < 1e-5


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_rcm_tiled_roundtrip(seed):
    """Random geometric-graph Laplacians (+ random SPD diagonal noise)
    through the RCM-reordered tile path: order-conversion round-trip and
    the lanes-major apply agree with scipy; fill metadata is consistent."""
    import scipy.sparse as sp

    from blockcg.operators import TiledOperator
    from blockcg.problems import rgg_laplacian

    rng = np.random.default_rng(100 + seed)
    n = int(rng.choice([700, 1500, 2048]))
    deg = float(rng.choice([6.0, 12.0, 25.0]))
    a = rgg_laplacian(n, degree=deg, seed=seed)
    a = (a + sp.diags(rng.random(n))).tocsr()  # break value symmetry a bit
    op = TiledOperator.from_scipy(a, dtype=jnp.float32, reorder="rcm")
    assert abs(op.nnz - (a.nnz + (op.n - n))) == 0
    assert 0 < op.fill <= 1
    k = int(rng.integers(1, 6))
    X = rng.standard_normal((n, k)).astype(np.float32)
    Xi = op.to_solver_order(jnp.asarray(X))
    # XLA path round-trip
    got = np.asarray(op.from_solver_order(op.matmat(Xi)), np.float64)
    want = a @ X.astype(np.float64)
    denom = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / denom < 1e-5
    # lanes-major apply on the internal (permuted) field
    Yt = op.matmat_t(jnp.asarray(Xi).T)
    got_k = np.asarray(op.from_solver_order(np.asarray(Yt).T), np.float64)
    assert np.abs(got_k - want).max() / denom < 1e-5
