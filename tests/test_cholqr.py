"""CholeskyQR(2) thin-QR stage (T-C3; reference R4 equivalent)."""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.solvers.common import cholqr


def _check(V, passes, dtype, orth_tol, rec_tol):
    Vj = jnp.asarray(V, dtype=dtype)
    Q, R = cholqr(Vj, passes=passes)
    Q, R = np.asarray(Q), np.asarray(R)
    k = V.shape[1]
    # orthonormality
    assert np.abs(Q.T @ Q - np.eye(k)).max() < orth_tol
    # reconstruction
    rec = np.abs(Q @ R - V).max() / (np.abs(V).max() or 1.0)
    assert rec < rec_tol
    # R upper triangular
    assert np.abs(np.tril(R, -1)).max() < rec_tol * np.abs(R).max()


@pytest.mark.parametrize("dtype,orth_tol", [(jnp.float32, 1e-5), (jnp.float64, 1e-13)])
def test_cholqr_wellconditioned(dtype, orth_tol):
    rng = np.random.default_rng(0)
    V = rng.standard_normal((300, 8))
    _check(V, 2, dtype, orth_tol, 1e-5 if dtype == jnp.float32 else 1e-12)


def test_cholqr2_illconditioned_f32():
    """Badly column-scaled + correlated input: CholeskyQR2 with equilibration
    must still produce an orthonormal Q in f32 (SURVEY.md §8 hard part 4)."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((500, 6))
    # nearly dependent columns with wildly different scales
    V = np.concatenate([base, base[:, :2] + 1e-3 * rng.standard_normal((500, 2))], axis=1)
    V = V * np.array([1.0, 1e-6, 1.0, 1e6, 1.0, 1.0, 1e-4, 1.0])
    Q, R = cholqr(jnp.asarray(V, dtype=jnp.float32), passes=2)
    Q = np.asarray(Q)
    assert np.abs(Q.T @ Q - np.eye(8)).max() < 1e-4


def test_cholqr_single_pass_reconstructs():
    rng = np.random.default_rng(2)
    V = rng.standard_normal((200, 4))
    _check(V, 1, jnp.float64, 1e-12, 1e-12)
