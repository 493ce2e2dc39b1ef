"""Even-odd Schur reduction tests (problems/dirac_eo.py, operators/schur.py)."""

import numpy as np
import pytest
import jax.numpy as jnp

import blockcg as bc
from blockcg.problems import dirac_bdia, dirac_eo, eo_split, solve_dirac_eo
from blockcg.problems.dirac import bdia_scipy


def _site_rows(sites: np.ndarray, ns: int, bs: int) -> np.ndarray:
    """Spin-major full rows (a*ns + s) for the given sites, all spins."""
    return (np.arange(bs)[:, None] * ns + sites[None, :]).reshape(-1)


def _blocks_of_A(L, bc, dtype=jnp.float64):
    """scipy A + even/odd full-row index arrays."""
    a = bdia_scipy(dirac_bdia(L, m=0.5, bc=bc, dtype=dtype))
    eo = dirac_eo(L, m=0.5, bc=bc, dtype=dtype)
    er = _site_rows(eo.even_sites, eo.ns, eo.bs)
    orr = _site_rows(eo.odd_sites, eo.ns, eo.bs)
    return a, eo, er, orr


@pytest.mark.parametrize("bc", ["periodic", "open"])
@pytest.mark.parametrize("L", [4, 6])
def test_parity_hops_match_A_blocks(bc, L):
    a, eo, er, orr = _blocks_of_A(L, bc)
    A = a.toarray()
    # A = cI - H in even/odd ordering: off-diagonal blocks are -H_eo, -H_oe
    H_eo = -A[np.ix_(er, orr)]
    H_oe = -A[np.ix_(orr, er)]
    rng = np.random.default_rng(0)
    k = 3
    Xo = rng.standard_normal((len(orr), k))
    Xe = rng.standard_normal((len(er), k))
    got_eo = np.asarray(eo.hop_eo.matmat_t(jnp.asarray(Xo.T))).T
    got_oe = np.asarray(eo.hop_oe.matmat_t(jnp.asarray(Xe.T))).T
    np.testing.assert_allclose(got_eo, H_eo @ Xo, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_oe, H_oe @ Xe, rtol=1e-12, atol=1e-12)
    # diagonal blocks are c I
    c = eo.c
    np.testing.assert_allclose(A[np.ix_(er, er)], c * np.eye(len(er)),
                               atol=1e-12)


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_eo_solve_matches_direct(bc):
    L = 4
    a, eo, er, orr = _blocks_of_A(L, bc)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((eo.n, 4))
    X, info = solve_dirac_eo(eo, B, tol=1e-11, max_iter=500)
    Xd = np.linalg.solve(a.toarray(), B)
    assert np.abs(X - Xd).max() / np.abs(Xd).max() < 1e-9


def test_eo_halves_iterations():
    """Schur solve converges in fewer iterations than the full solve."""
    L = 6
    op = dirac_bdia(L, m=0.25, dtype=jnp.float64)
    eo = dirac_eo(L, m=0.25, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    B = jnp.asarray(rng.standard_normal((op.n, 4)))
    _, i_full = bc.solve_sbcgrq(op, B, tol=1e-8, max_iter=500)
    _, i_eo = solve_dirac_eo(eo, B, tol=1e-8, max_iter=500)
    assert int(i_eo.iterations) < int(i_full.iterations)


def test_eo_complex():
    L = 4
    eo = dirac_eo(L, m=0.5, dtype=jnp.complex128)
    a = bdia_scipy(dirac_bdia(L, m=0.5, dtype=jnp.complex128))
    rng = np.random.default_rng(3)
    B = rng.standard_normal((eo.n, 3)) + 1j * rng.standard_normal((eo.n, 3))
    X, info = solve_dirac_eo(eo, jnp.asarray(B), tol=1e-10, max_iter=400)
    R = B - a @ X
    assert (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max() < 1e-9


def test_eo_f32_pallas_interpret():
    """f32 path through the const-hop parity hops."""
    L = 4
    eo = dirac_eo(L, m=0.5, dtype=jnp.float32)
    a = bdia_scipy(dirac_bdia(L, m=0.5, dtype=jnp.float64))
    rng = np.random.default_rng(4)
    B = rng.standard_normal((eo.n, 4)).astype(np.float32)
    X, info = solve_dirac_eo(eo, jnp.asarray(B), tol=1e-5, max_iter=300)
    R = B.astype(np.float64) - a @ X.astype(np.float64)
    rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()
    assert rel < 1e-4


def test_eo_inner_refinement_to_1e12():
    """1e-12 on the lattice operator: f64-outer refinement with the even-odd
    Schur solve as the f32 inner engine (composition of T-C5 and the EO
    reduction)."""
    import blockcg as bc

    L, m = 4, 0.5
    op = dirac_bdia(L, m=m, dtype=jnp.float32)  # f32 compute operator
    eo = dirac_eo(L, m=m, dtype=jnp.float32)
    a64 = bdia_scipy(dirac_bdia(L, m=m, dtype=jnp.float64))
    rng = np.random.default_rng(7)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)

    def inner(o, r, t):
        X, info = solve_dirac_eo(eo, r, tol=t, max_iter=300)
        return jnp.asarray(X), info

    # op64 must be the ORIGINAL f64 operator: the f32 compute operator's
    # entries are rounded, and refinement converges to whatever operator
    # evaluates the outer residual (see solve_refined docstring).
    X, info = bc.solve_refined(op, B, tol=1e-12, inner_tol=1e-5,
                               solve_fn=inner, max_cycles=6,
                               op64=dirac_bdia(L, m=m, dtype=jnp.float64))
    R = np.asarray(B, np.float64) - a64 @ np.asarray(X, np.float64)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-12


def test_gauged_eo_solve_matches_full():
    """Gauged Z2 even-odd Schur solve == direct gauged solve."""
    import blockcg as bc
    from blockcg.problems import dirac_gauged, dirac_gauged_eo
    from blockcg.problems.dirac import bdia_scipy
    from blockcg.problems.dirac_eo import solve_dirac_eo

    L = 4
    eo = dirac_gauged_eo(L, m=0.5, dtype=jnp.float64)
    full = dirac_gauged(L, m=0.5, dtype=jnp.float64)
    a = bdia_scipy(full)
    rng = np.random.default_rng(31)
    B = jnp.asarray(rng.standard_normal((full.n, 3)))
    X, info = solve_dirac_eo(eo, B, tol=1e-11, max_iter=500)
    R = a @ np.asarray(X) - np.asarray(B)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B), axis=0)).max()
    assert rel < 1e-9
    # Schur halves the iteration count vs the full gauged solve
    _, i_full = bc.solve_sbcgrq(full, B, tol=1e-11, max_iter=500)
    assert int(info.iterations) < int(i_full.iterations)


def test_gauged_eo_open_bc():
    from blockcg.problems import dirac_gauged, dirac_gauged_eo
    from blockcg.problems.dirac import bdia_scipy
    from blockcg.problems.dirac_eo import solve_dirac_eo

    L = 4
    eo = dirac_gauged_eo(L, m=0.5, bc="open", dtype=jnp.float64)
    full = dirac_gauged(L, m=0.5, bc="open", dtype=jnp.float64)
    a = bdia_scipy(full)
    rng = np.random.default_rng(32)
    B = jnp.asarray(rng.standard_normal((full.n, 2)))
    X, _ = solve_dirac_eo(eo, B, tol=1e-11, max_iter=500)
    R = a @ np.asarray(X) - np.asarray(B)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B), axis=0)).max()
    assert rel < 1e-9


def test_gauged_eo_f32_solve():
    """f32 end-to-end gauged even-odd solve."""
    from blockcg.problems import dirac_gauged, dirac_gauged_eo
    from blockcg.problems.dirac_eo import solve_dirac_eo

    L = 4
    eo = dirac_gauged_eo(L, m=0.5, dtype=jnp.float32)
    full = dirac_gauged(L, m=0.5, dtype=jnp.float32)
    rng = np.random.default_rng(33)
    B = jnp.asarray(rng.standard_normal((full.n, 4)), dtype=jnp.float32)
    X, info = solve_dirac_eo(eo, B, tol=1e-5, max_iter=300)
    R = np.asarray(full(X), np.float64) - np.asarray(B, np.float64)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-4


def test_gauged_eo_u1_solve_matches_full():
    """U(1) gauged even-odd (realified half-lattice hops) == direct
    complex gauged solve."""
    from blockcg.problems import dirac_gauged, dirac_gauged_eo
    from blockcg.problems.dirac import bdia_scipy
    from blockcg.problems.dirac_eo import solve_dirac_eo

    L = 4
    eo = dirac_gauged_eo(L, m=0.5, dtype=jnp.complex128)
    full = dirac_gauged(L, m=0.5, dtype=jnp.complex128)
    a = bdia_scipy(full)
    rng = np.random.default_rng(41)
    B = (rng.standard_normal((full.n, 3))
         + 1j * rng.standard_normal((full.n, 3)))
    X, info = solve_dirac_eo(eo, B, tol=1e-11, max_iter=800)
    R = a @ np.asarray(X) - B
    rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()
    assert rel < 1e-9


def test_shifted_eo_matches_direct_shifted_solves():
    """Multi-shift even-odd: one Krylov space solves (A + sigma_j) X = B for
    all shifts, matching direct per-shift solves of the FULL operator."""
    import blockcg as bc
    from blockcg.problems import dirac_cbdia, dirac_eo
    from blockcg.problems.dirac import bdia_scipy
    from blockcg.problems.dirac_eo import solve_dirac_eo_shifted

    L = 4
    eo = dirac_eo(L, m=0.5, dtype=jnp.float64)
    full = dirac_cbdia(L, m=0.5, dtype=jnp.float64)
    a = bdia_scipy(full.to_block_dia())
    rng = np.random.default_rng(80)
    B = jnp.asarray(rng.standard_normal((full.n, 3)))
    sigmas = [0.0, 0.7, 2.5]
    Xs, info = solve_dirac_eo_shifted(eo, B, sigmas, tol=1e-11, max_iter=800)
    n = full.n
    for j, sg in enumerate(sigmas):
        R = (a + sg * np.eye(n)) @ np.asarray(Xs[j]) - np.asarray(B)
        rel = (np.linalg.norm(R, axis=0)
               / np.linalg.norm(np.asarray(B), axis=0)).max()
        assert rel < 1e-9, (sg, rel)


def test_shifted_eo_gauged():
    """Gauged (Z2) multi-shift even-odd solves."""
    from blockcg.problems import dirac_gauged, dirac_gauged_eo
    from blockcg.problems.dirac import bdia_scipy
    from blockcg.problems.dirac_eo import solve_dirac_eo_shifted

    L = 4
    eo = dirac_gauged_eo(L, m=0.5, dtype=jnp.float64)
    full = dirac_gauged(L, m=0.5, dtype=jnp.float64)
    a = bdia_scipy(full)
    rng = np.random.default_rng(81)
    B = jnp.asarray(rng.standard_normal((full.n, 2)))
    sigmas = [0.1, 1.5]
    Xs, info = solve_dirac_eo_shifted(eo, B, sigmas, tol=1e-11, max_iter=800)
    for j, sg in enumerate(sigmas):
        R = (a + sg * np.eye(full.n)) @ np.asarray(Xs[j]) - np.asarray(B)
        rel = (np.linalg.norm(R, axis=0)
               / np.linalg.norm(np.asarray(B), axis=0)).max()
        assert rel < 1e-9, (sg, rel)


def test_shifted_eo_u1_complex():
    """U(1) multi-shift even-odd through the realified codec."""
    from blockcg.problems import dirac_gauged, dirac_gauged_eo
    from blockcg.problems.dirac import bdia_scipy
    from blockcg.problems.dirac_eo import solve_dirac_eo_shifted

    L = 4
    eo = dirac_gauged_eo(L, m=0.5, dtype=jnp.complex128)
    full = dirac_gauged(L, m=0.5, dtype=jnp.complex128)
    a = bdia_scipy(full)
    rng = np.random.default_rng(82)
    B = (rng.standard_normal((full.n, 2))
         + 1j * rng.standard_normal((full.n, 2)))
    sigmas = [0.0, 1.0]
    Xs, info = solve_dirac_eo_shifted(eo, B, sigmas, tol=1e-11, max_iter=800)
    for j, sg in enumerate(sigmas):
        R = (a + sg * np.eye(full.n)) @ np.asarray(Xs[j]) - B
        rel = (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()
        assert rel < 1e-9, (sg, rel)


def test_gauged_matrix_eo_hops_match_A_blocks():
    """Matrix-link parity hops == the full matrix's even/odd off-diagonal
    blocks (sign convention A = cI - H)."""
    from blockcg.problems import dirac_gauged_matrix
    from blockcg.problems.dirac_eo import dirac_gauged_matrix_eo

    L = 4
    full = dirac_gauged_matrix(L, m=0.5, dtype=jnp.float64)
    a = bdia_scipy(full).toarray()
    eo = dirac_gauged_matrix_eo(L, m=0.5, dtype=jnp.float64)
    er = _site_rows(eo.even_sites, eo.ns, eo.bs)
    orr = _site_rows(eo.odd_sites, eo.ns, eo.bs)
    H_eo = -a[np.ix_(er, orr)]
    H_oe = -a[np.ix_(orr, er)]
    rng = np.random.default_rng(90)
    k = 3
    Xo = rng.standard_normal((len(orr), k))
    Xe = rng.standard_normal((len(er), k))
    got_eo = np.asarray(eo.hop_eo.matmat_t(jnp.asarray(Xo.T))).T
    got_oe = np.asarray(eo.hop_oe.matmat_t(jnp.asarray(Xe.T))).T
    np.testing.assert_allclose(got_eo, H_eo @ Xo, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_oe, H_oe @ Xe, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a[np.ix_(er, er)],
                               eo.c * np.eye(len(er)), atol=1e-12)


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_gauged_matrix_eo_solve_matches_full(bc):
    """Matrix-link even-odd Schur solve == direct solve of the full
    matrix-link operator, and Schur cuts the iteration count."""
    from blockcg.problems import dirac_gauged_matrix
    from blockcg.problems.dirac_eo import dirac_gauged_matrix_eo

    L = 4
    eo = dirac_gauged_matrix_eo(L, m=0.5, bc=bc, dtype=jnp.float64)
    full = dirac_gauged_matrix(L, m=0.5, bc=bc, dtype=jnp.float64)
    a = bdia_scipy(full)
    rng = np.random.default_rng(91)
    B = jnp.asarray(rng.standard_normal((full.n, 3)))
    X, info = solve_dirac_eo(eo, B, tol=1e-11, max_iter=500)
    R = a @ np.asarray(X) - np.asarray(B)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B), axis=0)).max()
    assert rel < 1e-9
    from blockcg.solvers.sbcgrq import solve_sbcgrq

    _, i_full = solve_sbcgrq(full, B, tol=1e-11, max_iter=500)
    assert int(info.iterations) < int(i_full.iterations)


def test_gauged_matrix_eo_f32_solve():
    """f32 end-to-end matrix-link even-odd solve through the general block
    operator."""
    from blockcg.problems import dirac_gauged_matrix
    from blockcg.problems.dirac_eo import dirac_gauged_matrix_eo

    L = 4
    eo = dirac_gauged_matrix_eo(L, m=0.5, dtype=jnp.float32)
    full = dirac_gauged_matrix(L, m=0.5, dtype=jnp.float32)
    rng = np.random.default_rng(92)
    B = jnp.asarray(rng.standard_normal((full.n, 4)), dtype=jnp.float32)
    X, info = solve_dirac_eo(eo, B, tol=1e-5, max_iter=300)
    R = np.asarray(full(X), np.float64) - np.asarray(B, np.float64)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-4
