"""Distributed (row-sharded) tests on the fake 8-device CPU mesh.

SURVEY.md §5.2 item 3: run the full shard_map solver on the fake backend and
assert equality with the single-device run; halo-plan unit tests compare
partitioned SpMM against unpartitioned.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from blockcg import solve_cg, solve_sbcgrq
from blockcg.parallel import (
    from_dist_order,
    partition_bdia,
    partition_dia,
    row_mesh,
    solve_cg_dist,
    solve_bcg_dist,
    solve_sbcgrq_dist,
    to_dist_order,
)
from blockcg.parallel.api import shard_map
from blockcg.problems import (
    bdia_scipy,
    dirac_bdia,
    laplacian_dia,
    laplacian_scipy,
    random_block,
)

pytestmark = pytest.mark.usefixtures("mesh8")


def _dist_apply(dop, mesh, Xt):
    axis = dop.axis_name
    fn = shard_map(
        lambda o, xt: o.matmat_t(xt),
        mesh=mesh,
        in_specs=(dop.in_specs(), P(None, axis)),
        out_specs=P(None, axis),
        check_vma=False,
    )
    XtS = jax.device_put(Xt, NamedSharding(mesh, P(None, axis)))
    return jax.jit(fn)(dop, XtS)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_partitioned_dia_spmm_matches_global(D):
    shape = (32, 32)
    op = laplacian_dia(shape, dtype=jnp.float64)
    mesh = row_mesh(D)
    dop = partition_dia(op, D)
    rng = np.random.default_rng(0)
    Xt = jnp.asarray(rng.standard_normal((5, op.n)))
    got = np.asarray(_dist_apply(dop, mesh, Xt))
    want = np.asarray(op.matmat_t(Xt))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_partitioned_dia_single_shard():
    """D=1: the ring maps to self; toroidal semantics must be preserved."""
    op = laplacian_dia((16, 16), dtype=jnp.float64)
    mesh = row_mesh(1)
    dop = partition_dia(op, 1)
    Xt = jnp.asarray(np.random.default_rng(1).standard_normal((3, op.n)))
    got = np.asarray(_dist_apply(dop, mesh, Xt))
    np.testing.assert_allclose(got, np.asarray(op.matmat_t(Xt)), rtol=1e-12)


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_partitioned_bdia_spmm_matches_scipy(bc):
    """Site-sharded Dirac-like operator: distributed apply == scipy, with the
    distributed row-ordering permutation applied."""
    L, D, k = 4, 4, 3
    op = dirac_bdia(L, m=0.5, bc=bc, dtype=jnp.float64)
    a = bdia_scipy(op)
    mesh = row_mesh(D)
    dop = partition_bdia(op, D)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((op.n, k))
    Xd = to_dist_order(X, op.bs, D)  # distributed row ordering
    got_d = np.asarray(_dist_apply(dop, mesh, jnp.asarray(Xd.T))).T
    got = from_dist_order(got_d, op.bs, D)
    np.testing.assert_allclose(got, a @ X, rtol=1e-12, atol=1e-12)


def test_partitioned_matrix_link_spmm_matches_scipy():
    """Matrix-valued-link gauged operator, site-sharded: per-site bs x bs
    block VALUES cross shard edges (beyond the 0/1-masked and scalar-link
    crossings of the const-hop partitioner). The
    boundary-correction arrays must carry the full per-site blocks."""
    from blockcg.problems import dirac_gauged_matrix

    L, D, k = 4, 4, 3
    op = dirac_gauged_matrix(L, m=0.5, dtype=jnp.float64)
    a = bdia_scipy(op)
    mesh = row_mesh(D)
    dop = partition_bdia(op, D)
    rng = np.random.default_rng(21)
    X = rng.standard_normal((op.n, k))
    Xd = to_dist_order(X, op.bs, D)
    got_d = np.asarray(_dist_apply(dop, mesh, jnp.asarray(Xd.T))).T
    got = from_dist_order(got_d, op.bs, D)
    np.testing.assert_allclose(got, a @ X, rtol=1e-12, atol=1e-12)


def test_solve_sbcgrq_dist_matrix_links():
    """Distributed solve on the matrix-link operator (fake mesh): the full
    row-partitioned pipeline over site-varying block coefficients."""
    from blockcg.problems import dirac_gauged_matrix

    L, D = 4, 4
    op = dirac_gauged_matrix(L, m=0.5, dtype=jnp.float64)
    mesh = row_mesh(D)
    dop = partition_bdia(op, D)
    B = random_block(op.n, 4, seed=13)
    X_d, info = solve_sbcgrq_dist(dop, jnp.asarray(B), mesh, tol=1e-9,
                                  max_iter=300)
    assert bool(info.converged.all())
    a = bdia_scipy(op)
    X = np.asarray(X_d)
    res = np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-9


def test_dist_order_roundtrip():
    X = np.random.default_rng(3).standard_normal((4 * 16, 2))
    Xd = to_dist_order(X, 4, 4)
    np.testing.assert_array_equal(from_dist_order(Xd, 4, 4), X)


def test_solve_cg_dist_matches_single():
    shape = (32, 32)
    op = laplacian_dia(shape, dtype=jnp.float64)
    b = jnp.asarray(random_block(op.n, 1, seed=4)[:, 0])
    mesh = row_mesh(8)
    dop = partition_dia(op, 8)
    x_d, info_d = solve_cg_dist(dop, b, mesh, tol=1e-10, max_iter=2000)
    x_s, info_s = solve_cg(op, b, tol=1e-10, max_iter=2000)
    assert bool(info_d.converged.all())
    # same algorithm, different reduction order: equality within f64 slack
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s), rtol=1e-7, atol=1e-9)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2


def test_solve_sbcgrq_dist_matches_single():
    shape = (16, 16, 16)
    op = laplacian_dia(shape, dtype=jnp.float64)
    B = jnp.asarray(random_block(op.n, 6, seed=5))
    mesh = row_mesh(8)
    dop = partition_dia(op, 8)
    X_d, info_d = solve_sbcgrq_dist(dop, B, mesh, tol=1e-9, max_iter=400)
    assert bool(info_d.converged.all())
    a = laplacian_scipy(shape)
    res = np.linalg.norm(a @ np.asarray(X_d) - np.asarray(B), axis=0)
    res /= np.linalg.norm(np.asarray(B), axis=0)
    assert res.max() <= 2e-9
    # cross-check against single-device iteration count
    _, info_s = solve_sbcgrq(op, B, tol=1e-9, max_iter=400)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 3


def test_solve_bcg_dist_converges():
    op = laplacian_dia((24, 24), dtype=jnp.float64)
    B = jnp.asarray(random_block(op.n, 4, seed=6))
    mesh = row_mesh(4)
    dop = partition_dia(op, 4)
    X, info = solve_bcg_dist(dop, B, mesh, tol=1e-9, max_iter=500)
    assert bool(info.converged.all())
    a = laplacian_scipy((24, 24))
    res = np.linalg.norm(a @ np.asarray(X) - np.asarray(B), axis=0)
    res /= np.linalg.norm(np.asarray(B), axis=0)
    assert res.max() <= 2e-9


def test_solve_sbcgrq_dist_bdia():
    """Distributed solve on the lattice operator (config-4 logic, fake
    mesh). B/X are in NATURAL spin-major global ordering: the solve entry
    points shard the internal (k, bs, ns) field view on the site axis
    (to_dist_order remains only for the low-level flat-apply convention)."""
    L, D = 4, 4
    op = dirac_bdia(L, m=0.5, bc="periodic", dtype=jnp.float64)
    mesh = row_mesh(D)
    dop = partition_bdia(op, D)
    B = random_block(op.n, 4, seed=7)
    X_d, info = solve_sbcgrq_dist(dop, jnp.asarray(B), mesh, tol=1e-9,
                                  max_iter=200)
    assert bool(info.converged.all())
    X = np.asarray(X_d)
    a = bdia_scipy(op)
    res = np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-9


def test_solve_sbcgrq_dist_bdia_natural_order():
    """Distributed solve through the general block operator in NATURAL
    (spin-major global) ordering via the internal 3D field hooks — no
    to_dist_order permutation needed, no per-apply lane relayout."""
    from blockcg.parallel import solve_sbcgrq_dist

    L, D = 4, 4
    op = dirac_bdia(L, m=0.5, dtype=jnp.float32)
    dop = partition_bdia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(11)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    Xd, info_d = solve_sbcgrq_dist(dop, B, mesh, tol=1e-5, max_iter=300)
    a = bdia_scipy(op)
    R = np.asarray(B, np.float64) - a @ np.asarray(Xd, np.float64)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-4


def test_solve_shifted_sbcgrq_dist_matches_single():
    from blockcg.parallel import solve_shifted_sbcgrq_dist
    from blockcg.solvers.shifted_block import solve_shifted_sbcgrq

    shape = (32, 32)
    op = laplacian_dia(shape, dtype=jnp.float64)
    D = 4
    dop = partition_dia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(12)
    B = jnp.asarray(rng.standard_normal((op.n, 3)))
    sigmas = [0.0, 0.6, 2.0]
    Xd, info_d = solve_shifted_sbcgrq_dist(dop, B, sigmas, mesh, tol=1e-9,
                                           max_iter=500)
    Xs, info_s = solve_shifted_sbcgrq(op, B, sigmas, tol=1e-9, max_iter=500)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2
    assert np.abs(np.asarray(Xd) - np.asarray(Xs)).max() < 1e-7


def test_solve_psbcgrq_dist_matches_single():
    """Row-sharded preconditioned SBCGrQ (Jacobi on a scaled system)."""
    import scipy.sparse as sp

    from blockcg.parallel import solve_psbcgrq_dist
    from blockcg.solvers.pbcg import jacobi_preconditioner
    import blockcg as bc
    from blockcg.operators import DIAOperator

    n, D = 1024, 4
    rng = np.random.default_rng(20)
    s = np.exp(1.5 * rng.standard_normal(n))
    base = sp.diags(
        [np.full(n - 1, -1.0), np.full(n, 4.0), np.full(n - 1, -1.0)],
        [-1, 0, 1]).tocsr()
    Ds = sp.diags(np.sqrt(s))
    a = (Ds @ base @ Ds).tocsr()
    op = DIAOperator.from_scipy(a, dtype=jnp.float64)
    M = jacobi_preconditioner(op)
    dop = partition_dia(op, D)
    mesh = row_mesh(D)
    B = jnp.asarray(rng.standard_normal((n, 3)))
    Xd, info_d = solve_psbcgrq_dist(dop, B, M, mesh, tol=1e-9, max_iter=500)
    Xs, info_s = bc.solve_psbcgrq(op, B, M, tol=1e-9, max_iter=500)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2
    assert np.abs(np.asarray(Xd) - np.asarray(Xs)).max() < 1e-7


def test_solve_refined_dist_laplacian_1e10():
    """North-star composition (BASELINE.json north_star): f32 SBCGrQ inner
    solves fully row-sharded + f64 outer true-residual cycles, to 1e-10,
    matching the single-device refinement driver."""
    from blockcg import solve_refined
    from blockcg.parallel import solve_refined_dist

    shape = (12, 12, 12)
    op = laplacian_dia(shape, dtype=jnp.float32)
    a = laplacian_scipy(shape)
    B = random_block(op.n, 8, seed=0)
    mesh = row_mesh(8)
    dop = partition_dia(op, 8)
    X, info = solve_refined_dist(dop, jnp.asarray(B), mesh, tol=1e-10,
                                 inner_tol=1e-5)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10
    # cycle count matches the single-device driver (same algorithm)
    _, info_s = solve_refined(op, jnp.asarray(B), tol=1e-10, inner_tol=1e-5)
    assert abs(int(info.iterations) - int(info_s.iterations)) <= 1


def test_solve_refined_dist_bdia():
    """Distributed refinement through the block-lattice (Dirac-like)
    operator: halo'd block SpMM in the f64 outer cycle as well."""
    from blockcg.parallel import solve_refined_dist

    L, D = 4, 4
    op = dirac_bdia(L, m=0.5, bc="periodic", dtype=jnp.float32)
    a = bdia_scipy(op)
    B = random_block(op.n, 4, seed=9)
    mesh = row_mesh(D)
    dop = partition_bdia(op, D)
    X, info = solve_refined_dist(dop, jnp.asarray(B), mesh, tol=1e-10,
                                 inner_tol=1e-4)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10


def test_solve_sbcgrq_dist_vector_tol():
    """Per-RHS (k,) tolerance vector through the distributed entry point —
    mirrors solve_sbcgrq's contract (deflation stages rely on it)."""
    op = laplacian_dia((24, 24), dtype=jnp.float64)
    B = jnp.asarray(random_block(op.n, 4, seed=13))
    mesh = row_mesh(4)
    dop = partition_dia(op, 4)
    tols = np.array([1e-10, 1e-6, 1e-4, 1e-8])
    X, info = solve_sbcgrq_dist(dop, B, mesh, tol=tols, max_iter=2000)
    assert bool(info.converged.all())
    a = laplacian_scipy((24, 24))
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0)
    res /= np.linalg.norm(np.asarray(B), axis=0)
    assert (res <= 2 * tols).all()


def test_solve_sbcgrq_dist_complex_hermitian():
    """Complex Hermitian operator through the distributed path: conjugate-
    correct Grams under psum, complex halos through ppermute."""
    L, D = 4, 4
    op = dirac_bdia(L, m=0.5, dtype=jnp.complex128)
    a = bdia_scipy(op)
    rng = np.random.default_rng(21)
    B = rng.standard_normal((op.n, 3)) + 1j * rng.standard_normal((op.n, 3))
    mesh = row_mesh(D)
    dop = partition_bdia(op, D)
    X, info = solve_sbcgrq_dist(dop, jnp.asarray(B), mesh, tol=1e-9,
                                max_iter=300)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-9


def test_solve_sbcgrq_cheb_dist():
    """Row-sharded Chebyshev-preconditioned solve: fewer iterations (=
    fewer psum/QR rounds — the communication-avoiding trade), true-residual
    certified, matching the plain distributed solve."""
    from blockcg.operators.cheb import estimate_spectrum
    from blockcg.parallel import solve_sbcgrq_cheb_dist

    shape = (32, 32)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(random_block(op.n, 8, seed=30), jnp.float32)
    mesh = row_mesh(4)
    dop = partition_dia(op, 4)
    spectrum = tuple(float(x) for x in estimate_spectrum(op))
    Xc, inf_c = solve_sbcgrq_cheb_dist(dop, B, mesh, spectrum=spectrum,
                                       degree=6, tol=1e-5, max_iter=400)
    assert bool(inf_c.converged.all())
    a = laplacian_scipy(shape)
    res = np.linalg.norm(a @ np.asarray(Xc, np.float64) - np.asarray(B),
                         axis=0) / np.linalg.norm(np.asarray(B), axis=0)
    assert res.max() <= 1e-5  # certified true residual
    _, inf_p = solve_sbcgrq_dist(dop, B, mesh, tol=1e-5, max_iter=400)
    # the point: d-fold fewer latency-bound iterations
    assert int(inf_c.iterations) < 0.5 * int(inf_p.iterations)


@pytest.mark.parametrize("D", [3, 6])
def test_partition_dia_padded_non_divisor_D(D):
    """Non-power-of-two shard counts (SURVEY §4.5 device-count-agnostic
    meshes): n not divisible by D -> the last shard is padded with inert
    identity rows, and the solve matches the single-device run after the
    pads are truncated back off at the API boundary."""
    shape = (35, 31)  # n = 1085: 1085 % 3 == 2, 1085 % 6 == 5
    op = laplacian_dia(shape, dtype=jnp.float64)
    mesh = row_mesh(D)
    dop = partition_dia(op, D)
    assert dop.pad_sites > 0
    B = jnp.asarray(random_block(op.n, 4, seed=9))
    X_d, info_d = solve_sbcgrq_dist(dop, B, mesh, tol=1e-9, max_iter=600)
    assert X_d.shape == (op.n, 4)
    assert bool(info_d.converged.all())
    a = laplacian_scipy(shape)
    res = np.linalg.norm(a @ np.asarray(X_d) - np.asarray(B), axis=0)
    res /= np.linalg.norm(np.asarray(B), axis=0)
    assert res.max() <= 2e-9
    _, info_s = solve_sbcgrq(op, B, tol=1e-9, max_iter=600)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 3


def test_partition_bdia_padded_non_divisor_D():
    """Open-boundary block operator at a non-divisor shard count: padded
    sites carry identity blocks, solve matches scipy in natural ordering."""
    L, D = 4, 3  # ns = 256, 256 % 3 == 1 -> 2 padded sites
    op = dirac_bdia(L, m=0.5, bc="open", dtype=jnp.float64)
    mesh = row_mesh(D)
    dop = partition_bdia(op, D)
    assert dop.pad_sites == 2
    B = random_block(op.n, 3, seed=10)
    X_d, info = solve_sbcgrq_dist(dop, jnp.asarray(B), mesh, tol=1e-9,
                                  max_iter=300)
    assert X_d.shape == (op.n, 3)
    assert bool(info.converged.all())
    a = bdia_scipy(op)
    res = np.linalg.norm(a @ np.asarray(X_d) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-9


def test_partition_padded_rejects_periodic_wraps():
    """Periodic operators have live wrap couplings: padding would change
    answers, so non-divisor D must raise with the valid shard counts."""
    op = dirac_bdia(4, m=0.5, bc="periodic", dtype=jnp.float64)
    with pytest.raises(ValueError, match="wrap"):
        partition_bdia(op, 3)
    from blockcg.parallel import partition_cbdia
    from blockcg.problems import dirac_cbdia

    opc = dirac_cbdia(8, m=0.5, dtype=jnp.float32)
    with pytest.raises(ValueError, match="[Vv]alid D"):
        partition_cbdia(opc, 6)


def test_solve_sbcgrq_cheb_dist_cycles_history_vector_tol():
    """Multi-cycle Chebyshev-dist bookkeeping: a per-column (k,) tol is
    accepted, per-cycle histories CONCATENATE (not last-cycle-only), and
    the aggregates (per_rhs_iters sum,
    breakdown or-reduce) survive the outer python loop."""
    from blockcg.operators.cheb import estimate_spectrum
    from blockcg.parallel import solve_sbcgrq_cheb_dist

    shape = (24, 24)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(random_block(op.n, 4, seed=31), jnp.float32)
    mesh = row_mesh(4)
    dop = partition_dia(op, 4)
    spectrum = tuple(float(x) for x in estimate_spectrum(op))
    tol = np.asarray([1e-5, 1e-4, 1e-5, 1e-4])
    # max_iter low enough that one cycle cannot finish -> >= 2 cycles.
    Xc, info = solve_sbcgrq_cheb_dist(dop, B, mesh, spectrum=spectrum,
                                      degree=4, tol=tol, max_iter=4,
                                      max_cycles=8, record_history=True)
    assert bool(info.converged.all())
    assert info.history is not None and info.history.shape[0] > 4
    assert info.per_rhs_iters.shape == (4,)
    assert int(info.per_rhs_iters.max()) >= int(info.per_rhs_iters.min())
    assert not bool(info.breakdown)
    a = laplacian_scipy(shape)
    res = np.linalg.norm(a @ np.asarray(Xc, np.float64) - np.asarray(B),
                         axis=0) / np.linalg.norm(np.asarray(B), axis=0)
    assert (res <= tol * 10).all()  # true residual near per-column tols


def test_solve_sbcgrq_dist_bf16_fields():
    """Row-sharded solve with bf16 fields (capacity mode on a mesh): psums
    ride f32 Grams (acc_dtype), state stays bf16, converges to a
    bf16-limited tolerance matching the single-device bf16 run."""
    shape = (24, 24)
    op = laplacian_dia(shape, dtype=jnp.bfloat16)
    mesh = row_mesh(4)
    dop = partition_dia(op, 4)
    assert dop.dtype == jnp.bfloat16
    rng = np.random.default_rng(21)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.bfloat16)
    X, info = solve_sbcgrq_dist(dop, B, mesh, tol=2e-2, max_iter=400)
    assert X.dtype == jnp.bfloat16
    a = laplacian_scipy(shape)
    Bf = np.asarray(B, np.float64)
    res = np.linalg.norm(a @ np.asarray(X, np.float64) - Bf, axis=0)
    res /= np.linalg.norm(Bf, axis=0)
    # True-residual floor at bf16 resolution (measured 0.058 here — the
    # sharded path adds bf16 halo rounding over the 0.04-ish single-device
    # floor); accuracy beyond this tier comes from solve_refined_dist.
    assert res.max() <= 8e-2
