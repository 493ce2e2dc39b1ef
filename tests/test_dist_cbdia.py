"""Distributed const-hop block operator (partition_cbdia) on the fake mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import blockcg as bc
from blockcg.problems import dirac_cbdia, dirac_bdia
from blockcg.problems.dirac import bdia_scipy
from blockcg.parallel import partition_cbdia, row_mesh, solve_sbcgrq_dist

shard_map = jax.shard_map

pytestmark = pytest.mark.usefixtures("mesh8")

D = 8


def _op(L=8):
    return dirac_cbdia(L, m=0.5, bc="periodic", dtype=jnp.float32)


def test_partition_cbdia_structure():
    op = _op()
    dop = partition_cbdia(op, D)
    # only the toroidal t-hops cross site-contiguous shard boundaries
    offs = sorted(op.offsets[c[0]] for c in dop.crossings)
    st = 8**3
    assert offs == [-st, st]
    assert dop.local.num_sites == op.num_sites // D


def test_dist_cbdia_apply_matches_global():
    """Merged (m, ns) fields, site axis sharded: local apply + halo slab
    corrections must equal the single-device apply."""
    op = _op()
    dop = partition_cbdia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(0)
    k = 4  # m = 16
    Xm = jnp.asarray(rng.standard_normal((k * op.bs, op.ns)),
                     dtype=jnp.float32)
    Xs = jax.device_put(Xm, jax.NamedSharding(mesh, P(None, "rows")))

    fn = shard_map(
        lambda o, x: o.matmat_t(x),
        mesh=mesh,
        in_specs=(dop.in_specs(), P(None, "rows")),
        out_specs=P(None, "rows"),
        check_vma=False,
    )
    got = np.asarray(jax.jit(fn)(dop, Xs))
    want = np.asarray(op.matmat_t(Xm))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6


def test_dist_cbdia_solve_matches_single_device():
    op = _op()
    dop = partition_cbdia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(1)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    Xd, info_d = solve_sbcgrq_dist(dop, B, mesh, tol=1e-5, max_iter=200)
    Xs, info_s = bc.solve_sbcgrq(op, B, tol=1e-5, max_iter=200)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2
    a = bdia_scipy(dirac_bdia(8, m=0.5, bc="periodic", dtype=jnp.float64))
    R = np.asarray(B, np.float64) - a @ np.asarray(Xd, np.float64)
    rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-4


def test_partition_cbdia_masked_crossing_open_bc():
    """Open bc: the crossing t-hops are 0/1-masked at the global boundary.
    The edge values ride the crossing correction (zeroing the last shard's
    wrap), so the partition is exact — previously this was rejected."""
    op = dirac_cbdia(8, m=0.5, bc="open", dtype=jnp.float32)
    dop = partition_cbdia(op, D)
    assert any(v is not None for v in dop.cross_vals)
    mesh = row_mesh(D)
    rng = np.random.default_rng(14)
    k = 2
    Xm = jnp.asarray(rng.standard_normal((k * op.bs, op.ns)),
                     dtype=jnp.float32)
    Xs = jax.device_put(Xm, jax.NamedSharding(mesh, P(None, "rows")))
    fn = shard_map(
        lambda o, x: o.matmat_t(x),
        mesh=mesh,
        in_specs=(dop.in_specs(), P(None, "rows")),
        out_specs=P(None, "rows"),
        check_vma=False,
    )
    got = np.asarray(jax.jit(fn)(dop, Xs))
    want = np.asarray(op.matmat_t(Xm))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_dist_cbdia_shifted_matches_single():
    from blockcg.parallel import solve_shifted_sbcgrq_dist
    from blockcg.solvers.shifted_block import solve_shifted_sbcgrq

    op = _op()
    dop = partition_cbdia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(9)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    sigmas = [0.0, 0.8]
    Xd, info_d = solve_shifted_sbcgrq_dist(dop, B, sigmas, mesh, tol=1e-5,
                                           max_iter=200)
    Xs, info_s = solve_shifted_sbcgrq(op, B, sigmas, tol=1e-5, max_iter=200)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2
    assert np.abs(np.asarray(Xd) - np.asarray(Xs)).max() < 1e-4


def test_dist_cbdia_fused_gram_matches_global():
    """Distributed matmat+gram on the fake mesh: psum of local Grams ==
    global X^T (A X)."""
    from jax import lax

    op = _op()
    dop = partition_cbdia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(10)
    k = 4
    Xm = jnp.asarray(rng.standard_normal((k * op.bs, op.ns)),
                     dtype=jnp.float32)
    Xs = jax.device_put(Xm, jax.NamedSharding(mesh, P(None, "rows")))

    def body(o, x):
        y, gl = o.matmat_gram_t(x)
        assert gl is not None
        return y, lax.psum(gl, "rows")

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(dop.in_specs(), P(None, "rows")),
        out_specs=(P(None, "rows"), P()),
        check_vma=False,
    )
    got_y, got_g = jax.jit(fn)(dop, Xs)
    want_y = np.asarray(op.matmat_t(Xm))
    np.testing.assert_allclose(np.asarray(got_y), want_y, rtol=2e-5,
                               atol=2e-5)
    want_g = (np.asarray(Xm, np.float64)
              @ np.asarray(want_y, np.float64).T)
    want_g = op.gram_contract(jnp.asarray(want_g)).astype(np.float64)
    np.testing.assert_allclose(np.asarray(got_g), np.asarray(want_g),
                               rtol=1e-4, atol=1e-3)


def test_dist_gauged_cbdia_matches_global():
    """Gauged (Z2 value-masked) operator partitioned over shards: crossing
    diagonals carry edge link values into the halo correction."""
    from blockcg.problems import dirac_gauged_cbdia

    op = dirac_gauged_cbdia(8, m=0.5, dtype=jnp.float32)
    dop = partition_cbdia(op, D)
    assert any(v is not None for v in dop.cross_vals)
    mesh = row_mesh(D)
    rng = np.random.default_rng(11)
    k = 4
    Xm = jnp.asarray(rng.standard_normal((k * op.bs, op.ns)),
                     dtype=jnp.float32)
    Xs = jax.device_put(Xm, jax.NamedSharding(mesh, P(None, "rows")))
    fn = shard_map(
        lambda o, x: o.matmat_t(x),
        mesh=mesh,
        in_specs=(dop.in_specs(), P(None, "rows")),
        out_specs=P(None, "rows"),
        check_vma=False,
    )
    got = np.asarray(jax.jit(fn)(dop, Xs))
    want = np.asarray(op.matmat_t(Xm))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6


def test_dist_gauged_cbdia_solve_matches_single():
    from blockcg.problems import dirac_gauged_cbdia

    op = dirac_gauged_cbdia(8, m=0.5, dtype=jnp.float32)
    dop = partition_cbdia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(12)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    Xd, info_d = solve_sbcgrq_dist(dop, B, mesh, tol=1e-5, max_iter=200)
    Xs, info_s = bc.solve_sbcgrq(op, B, tol=1e-5, max_iter=200)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2
    assert np.abs(np.asarray(Xd) - np.asarray(Xs)).max() < 1e-4


def test_dist_gauged_fused_gram_matches_global():
    from jax import lax

    from blockcg.problems import dirac_gauged_cbdia

    op = dirac_gauged_cbdia(8, m=0.5, dtype=jnp.float32)
    dop = partition_cbdia(op, D)
    mesh = row_mesh(D)
    rng = np.random.default_rng(13)
    k = 2
    Xm = jnp.asarray(rng.standard_normal((k * op.bs, op.ns)),
                     dtype=jnp.float32)
    Xs = jax.device_put(Xm, jax.NamedSharding(mesh, P(None, "rows")))

    def body(o, x):
        y, gl = o.matmat_gram_t(x)
        assert gl is not None
        return y, lax.psum(gl, "rows")

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(dop.in_specs(), P(None, "rows")),
        out_specs=(P(None, "rows"), P()),
        check_vma=False,
    )
    got_y, got_g = jax.jit(fn)(dop, Xs)
    want_y = np.asarray(op.matmat_t(Xm))
    np.testing.assert_allclose(np.asarray(got_y), want_y, rtol=2e-5,
                               atol=2e-5)
    want_g = op.gram_contract(jnp.asarray(
        np.asarray(Xm, np.float64) @ np.asarray(want_y, np.float64).T))
    np.testing.assert_allclose(np.asarray(got_g), np.asarray(want_g),
                               rtol=1e-4, atol=1e-3)


def test_dist_schur_eo_solve_matches_single():
    """Distributed even-odd Schur solve (two halo rounds per apply) on the
    fake mesh == single-device Schur solve. Gauged (Z2) variant."""
    from blockcg.parallel import partition_dirac_eo
    from blockcg.problems import dirac_gauged_eo
    from blockcg.problems.dirac_eo import dirac_eo

    for eo in (dirac_eo(8, m=0.5, dtype=jnp.float32),
               dirac_gauged_eo(8, m=0.5, dtype=jnp.float32)):
        dschur = partition_dirac_eo(eo, D)
        mesh = row_mesh(D)
        n2 = eo.n // 2
        rng = np.random.default_rng(15)
        rhs = jnp.asarray(rng.standard_normal((n2, 3)), dtype=jnp.float32)
        Xd, info_d = solve_sbcgrq_dist(dschur, rhs, mesh, tol=1e-5,
                                       max_iter=200)
        Xs, info_s = bc.solve_sbcgrq(eo.schur, rhs, tol=1e-5, max_iter=200)
        assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2
        assert np.abs(np.asarray(Xd) - np.asarray(Xs)).max() < 1e-4


def test_solve_dirac_eo_dist_end_to_end():
    """Full distributed EO pipeline: split -> dist Schur -> reconstruct."""
    from blockcg.problems import dirac_gauged, dirac_gauged_eo
    from blockcg.problems.dirac_eo import solve_dirac_eo_dist

    eo = dirac_gauged_eo(8, m=0.5, dtype=jnp.float32)
    full = dirac_gauged(8, m=0.5, dtype=jnp.float32)
    mesh = row_mesh(D)
    rng = np.random.default_rng(16)
    B = jnp.asarray(rng.standard_normal((full.n, 3)), dtype=jnp.float32)
    X, info = solve_dirac_eo_dist(eo, B, mesh, tol=1e-5, max_iter=300)
    R = np.asarray(full(jnp.asarray(X)), np.float64) - np.asarray(B, np.float64)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-4


def test_dist_gauged_f64_cross_vals_exact():
    """Regression: crossing edge values keep the mask dtype (f64 links were
    once truncated to f32, flooring distributed accuracy at ~1e-8)."""
    from blockcg.problems import dirac_gauged_eo
    from blockcg.parallel import partition_dirac_eo

    eo = dirac_gauged_eo(8, m=0.5, dtype=jnp.complex128)
    dschur = partition_dirac_eo(eo, D)
    for v in dschur.hop_eo.cross_vals:
        if v is not None:
            assert v.dtype == jnp.float64, v.dtype
    mesh = row_mesh(D)
    rng = np.random.default_rng(17)
    # merged (m = bs*k, ns2) half field, k = 2; apply equality at f64
    Xm = jnp.asarray(rng.standard_normal((2 * eo.bs, eo.ns // 2)))
    Xs = jax.device_put(Xm, jax.NamedSharding(mesh, P(None, "rows")))
    fn = shard_map(
        lambda o, x: o.matmat_t(x),
        mesh=mesh,
        in_specs=(dschur.in_specs(), P(None, "rows")),
        out_specs=P(None, "rows"),
        check_vma=False,
    )
    got = np.asarray(jax.jit(fn)(dschur, Xs))
    want = np.asarray(eo.schur.matmat_t(Xm))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


def test_dist_eo_normal_shifted_matches_single():
    """Distributed multi-shift EO base operator: shifted block solve over
    the fake mesh == single-device."""
    from blockcg.operators.schur import EONormalOperator
    from blockcg.parallel import (
        DistEONormalOperator, partition_cbdia, solve_shifted_sbcgrq_dist,
    )
    from blockcg.problems.dirac_eo import dirac_gauged_eo
    from blockcg.solvers.shifted_block import solve_shifted_sbcgrq

    eo = dirac_gauged_eo(8, m=0.5, dtype=jnp.float32)
    mu0 = (eo.c + 0.0) ** 2
    kop = EONormalOperator(hop_eo=eo.hop_eo, hop_oe=eo.hop_oe, mu=mu0)
    dkop = DistEONormalOperator(
        hop_eo=partition_cbdia(eo.hop_eo, D),
        hop_oe=partition_cbdia(eo.hop_oe, D),
        mu=mu0,
    )
    mesh = row_mesh(D)
    rng = np.random.default_rng(18)
    n2 = eo.n // 2
    B = jnp.asarray(rng.standard_normal((n2, 3)), dtype=jnp.float32)
    mus = [0.0, 3.0]
    Xd, info_d = solve_shifted_sbcgrq_dist(dkop, B, mus, mesh, tol=1e-5,
                                           max_iter=200)
    Xs, info_s = solve_shifted_sbcgrq(kop, B, mus, tol=1e-5, max_iter=200)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2
    assert np.abs(np.asarray(Xd) - np.asarray(Xs)).max() < 1e-4
