"""Gauged (site-dependent link) Dirac flavor — exercises the general
per-site block path with a genuinely non-translation-invariant operator."""

import numpy as np
import pytest
import jax.numpy as jnp

import blockcg as bc
from blockcg import solve_sbcgrq
from blockcg.problems import dirac_gauged, random_block
from blockcg.problems.dirac import bdia_scipy


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-12),
                                       (jnp.complex128, 1e-12)])
def test_gauged_hermitian_pd(dtype, tol):
    a = bdia_scipy(dirac_gauged(3, m=0.5, dtype=dtype)).toarray()
    assert np.abs(a - a.conj().T).max() < tol
    assert np.linalg.eigvalsh(a).min() >= 0.25 - 1e-9


def test_gauged_differs_from_constant():
    from blockcg.problems import dirac_bdia

    ag = bdia_scipy(dirac_gauged(3, m=0.5, dtype=jnp.float64))
    ac = bdia_scipy(dirac_bdia(3, m=0.5, dtype=jnp.float64))
    assert abs(ag - ac).max() > 0.1  # links actually vary


def test_gauged_apply_matches_scipy_f32():
    op = dirac_gauged(4, m=0.5, dtype=jnp.float32)
    a = bdia_scipy(op)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((op.n, 5)).astype(np.float32)
    got = np.asarray(op.matmat_t(jnp.asarray(X.T))).T
    want = a @ X
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_gauged_solve():
    op = dirac_gauged(4, m=0.5, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-5, max_iter=300)
    a = bdia_scipy(op)
    R = np.asarray(B, np.float64) - a @ np.asarray(X, np.float64)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-4


def test_gauged_complex_realified_solve():
    """U(1)-gauged complex Hermitian through the realified real path."""
    from blockcg.operators import realify

    op = dirac_gauged(3, m=0.5, dtype=jnp.complex64)
    rop = realify(op)
    rng = np.random.default_rng(2)
    B = (rng.standard_normal((op.n, 3))
         + 1j * rng.standard_normal((op.n, 3))).astype(np.complex64)
    X, info = bc.solve_sbcgrq(rop, B, tol=1e-5, max_iter=300)
    a = bdia_scipy(op)
    R = B.astype(np.complex128) - a @ np.asarray(X, np.complex128)
    rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()
    assert rel < 1e-4


def test_gauged_bf16_blocks():
    """bf16-stored blocks (memory option): ~4e-4 operator rounding."""
    from blockcg.operators.base import astype

    op = dirac_gauged(4, m=0.5, dtype=jnp.float32)
    op16 = astype(op, jnp.bfloat16)
    assert op16.blocks.dtype == jnp.bfloat16
    rng = np.random.default_rng(5)
    X = rng.standard_normal((op.n, 4)).astype(np.float32)
    y32 = np.asarray(op.matmat_t(jnp.asarray(X.T)))
    y16 = np.asarray(op16.matmat_t(jnp.asarray(X.T)))
    rel = np.abs(y16 - y32).max() / np.abs(y32).max()
    assert rel < 5e-3
    assert rel > 0  # genuinely stored at lower precision


def test_gauged_cbdia_matches_gauged_real():
    """Z2 links as const-hop value masks: identical matrix to dirac_gauged."""
    from blockcg.problems import dirac_gauged_cbdia

    for bc in ("periodic", "open"):
        a = bdia_scipy(dirac_gauged(3, m=0.5, bc=bc, dtype=jnp.float64))
        b = bdia_scipy(
            dirac_gauged_cbdia(3, m=0.5, bc=bc, dtype=jnp.float64)
            .to_block_dia()
        )
        assert abs((a - b)).max() < 1e-14


def test_gauged_cbdia_complex_apply_matches_oracle():
    """U(1) links via the realified K1/K2 const-hop pair."""
    from blockcg.problems import dirac_gauged_cbdia

    op = dirac_gauged_cbdia(3, m=0.5, dtype=jnp.complex128)
    a = bdia_scipy(dirac_gauged(3, m=0.5, dtype=jnp.complex128))
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((a.shape[0], 3))
         + 1j * rng.standard_normal((a.shape[0], 3)))
    got = np.asarray(op.matmat(jnp.asarray(X) if False else X))
    want = a @ X
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_gauged_cbdia_kernel_interpret():
    """Duplicate-offset value-masked diagonals through the merged apply."""
    from blockcg.problems import dirac_gauged_cbdia

    op = dirac_gauged_cbdia(4, m=0.5, dtype=jnp.float32)
    a = bdia_scipy(dirac_gauged(4, m=0.5, dtype=jnp.float64))
    rng = np.random.default_rng(6)
    k = 2  # m = 8
    X = rng.standard_normal((op.n, k)).astype(np.float32)
    Xm = op.to_internal(jnp.asarray(X.T))
    Ym = op.matmat_t(Xm)
    Yt = np.asarray(op.from_internal(Ym)).T
    want = a @ X
    assert np.abs(Yt - want).max() / np.abs(want).max() < 1e-5


def test_gauged_cbdia_solve_matches_general():
    """SBCGrQ through the const-hop gauged container == general container."""
    import blockcg as bc
    from blockcg.problems import dirac_gauged_cbdia

    opc = dirac_gauged_cbdia(4, m=0.5, dtype=jnp.float32)
    opg = dirac_gauged(4, m=0.5, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    B = jnp.asarray(rng.standard_normal((opc.n, 4)), dtype=jnp.float32)
    Xc, ic = bc.solve_sbcgrq(opc, B, tol=1e-5, max_iter=300)
    Xg, ig = bc.solve_sbcgrq(opg, B, tol=1e-5, max_iter=300)
    assert abs(int(ic.iterations) - int(ig.iterations)) <= 2
    assert np.abs(np.asarray(Xc) - np.asarray(Xg)).max() < 1e-4


def test_gauged_cbdia_u1_core_kernel_interpret():
    """True duplicate-offset coverage: the complex64 U(1) operator's
    realified f32 core (K1/K2 value-masked pairs share offsets) through the
    merged apply vs the scipy oracle of its block form."""
    from blockcg.problems import dirac_gauged_cbdia

    w = dirac_gauged_cbdia(4, m=0.5, dtype=jnp.complex64)
    core = w.real_op
    # duplicate offsets must actually be present
    assert len(core.offsets) > len(set(core.offsets))
    rng = np.random.default_rng(8)
    k = 2  # m = 2*bs_r... bs_r = 8 -> m = 16
    Xm = jnp.asarray(rng.standard_normal((core.bs * k, core.ns)),
                     dtype=jnp.float32)
    got = core.matmat_t(Xm)
    a = bdia_scipy(core.to_block_dia())
    want = core.to_internal(jnp.asarray(
        (a @ np.asarray(core.from_internal(Xm), np.float64).T).T))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    # and the gram path over the same duplicate-offset structure
    Y, G = core.matmat_gram_t(Xm)
    np.testing.assert_allclose(np.asarray(Y), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    want_g = core.gram_contract(jnp.asarray(
        np.asarray(Xm, np.float64) @ np.asarray(want, np.float64).T))
    np.testing.assert_allclose(np.asarray(G), np.asarray(want_g),
                               rtol=1e-4, atol=1e-3)


def test_gauged_matrix_links_spd_and_solve():
    """Matrix-valued (SU(N)-style) links: the non-factorizable gauged case
    that requires the general per-site block kernel. SPD by the
    norm-preserving orthogonal links; solve matches the scipy oracle."""
    from blockcg.problems import dirac_gauged_matrix

    op = dirac_gauged_matrix(4, m=0.5, dtype=jnp.float64)
    a = bdia_scipy(op)
    dense = a.toarray()
    assert np.abs(dense - dense.T).max() == 0.0
    assert np.linalg.eigvalsh(dense).min() >= 0.25
    B = random_block(op.n, 4, seed=17)
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-9, max_iter=300)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-9


def test_gauged_matrix_links_hermitian():
    """Complex Hermitian matrix links (unitary U): the full lattice-QCD-like
    flavor, solved through the conjugate-correct complex path."""
    from blockcg.problems import dirac_gauged_matrix

    op = dirac_gauged_matrix(3, m=0.5, dtype=jnp.complex128)
    a = bdia_scipy(op)
    rng = np.random.default_rng(18)
    B = rng.standard_normal((op.n, 3)) + 1j * rng.standard_normal((op.n, 3))
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-9, max_iter=300)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-9
