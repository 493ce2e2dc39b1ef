"""Chebyshev-preconditioned SBCGrQ tests (operators/cheb.py, solvers/poly.py)."""

import numpy as np
import jax.numpy as jnp

import blockcg as bc
from blockcg.operators.cheb import ChebyshevOperator, estimate_spectrum
from blockcg.problems import laplacian_dia, laplacian_scipy


def test_estimate_spectrum_laplacian():
    op = laplacian_dia((32, 32), dtype=jnp.float32)
    lo, hi = estimate_spectrum(op)
    a = laplacian_scipy((32, 32)).toarray()
    ev = np.linalg.eigvalsh(a)
    assert float(hi) >= ev[-1] * 0.999  # hi must BOUND the spectrum
    assert float(hi) <= ev[-1] * 1.2
    # lo may overestimate lambda_min (slow flipped-power convergence) — that
    # is safe: p(t)t = 1 - q(t) > 0 for every t > 0 because q(0) = 1 and q
    # decreases, so M A stays PD and CG handles the sub-lo modes.
    assert 0 < float(lo) < float(hi)


def test_cheb_operator_spd_and_commutes():
    """M A must be symmetric positive definite (M = p(A) commutes with A)."""
    op = laplacian_dia((16, 16), dtype=jnp.float64)
    lo, hi = estimate_spectrum(op)
    pop = ChebyshevOperator(base=op, lo=lo, hi=hi, degree=3)
    n = op.n
    E = jnp.eye(n, dtype=jnp.float64)
    MA = np.asarray(pop.matmat_t(E.T)).T  # dense MA
    assert np.abs(MA - MA.T).max() < 1e-10
    assert np.linalg.eigvalsh(MA).min() > 0


def test_cheb_step_kernel_interpret():
    """M r = p_d(A) r vs the Chebyshev semi-iteration (Saad Alg. 12.1)
    written out in float64 numpy: d - 1 steps of
    dlt' = rho' rho dlt + (2 rho' / delta)(r - A z),  z' = z + dlt'."""
    shape = (32, 32)
    op = laplacian_dia(shape, dtype=jnp.float32)
    a = laplacian_scipy(shape)
    lo, hi = 0.05, 8.0
    degree = 4
    pop = ChebyshevOperator(base=op, lo=jnp.float32(lo), hi=jnp.float32(hi),
                            degree=degree)
    rng = np.random.default_rng(0)
    R = rng.standard_normal((8, op.n)).astype(np.float32)
    got = np.asarray(pop.apply_m_t(jnp.asarray(R)), np.float64)

    theta, delta = (hi + lo) / 2, (hi - lo) / 2
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    r = R.astype(np.float64).T
    z = r / theta
    dlt = z
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        dlt = rho_new * rho * dlt + (2.0 * rho_new / delta) * (r - a @ z)
        z = z + dlt
        rho = rho_new
    np.testing.assert_allclose(got, z.T, rtol=1e-5,
                               atol=1e-5 * np.abs(z).max())


def test_cheb_solve_matches_direct_and_cuts_iterations():
    op = laplacian_dia((64, 64), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    B = jnp.asarray(rng.standard_normal((op.n, 8)), dtype=jnp.float32)
    X, info = bc.solve_sbcgrq_cheb(op, B, degree=4, tol=1e-6, max_iter=500)
    a = laplacian_scipy((64, 64))
    R = np.asarray(B, np.float64) - a @ np.asarray(X, np.float64)
    rel = (np.linalg.norm(R, axis=0)
           / np.linalg.norm(np.asarray(B, np.float64), axis=0)).max()
    assert rel < 1e-6 * 1.1
    assert bool(info.converged.all())
    _, plain = bc.solve_sbcgrq(op, B, tol=1e-6, max_iter=500)
    # Iterations drop substantially (the chain cost amortizes over the
    # polynomial degree); block deflation of sub-lo modes keeps the
    # overestimated lo effective — see solvers/poly.py.
    assert int(info.iterations) < int(plain.iterations) * 0.65
