"""bf16 field-storage tests (capacity mode).

Large solver fields (X/W/P/Z and operator diagonals) may be stored bfloat16
with ALL accumulation in f32: applies and updates widen on the fly, k x k
solver algebra (Grams, alpha/rho/S, monitors) stays f32
(solvers/common.acc_dtype). This halves memory traffic and field footprint.
Accuracy is recovered by iterative refinement (bf16 inner + f32/f64 outer).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from blockcg import solve_sbcgrq
from blockcg.operators import DIAOperator
from blockcg.problems import laplacian_dia, laplacian_scipy
from blockcg.solvers.common import (
    f_gram, f_mm2_update_gram, f_mm_update, f_mm_update_gram, f_px_update,
    f_qr_p_update, f_qr_px_update, f_xr_update_gram,
)
from blockcg.solvers.refine import solve_refined

BF = jnp.bfloat16


def _field(shape, seed, dtype=BF):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape), dtype=dtype)


def _kk(k, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((k, k)), dtype=jnp.float32)


def test_stencil_kernel_bf16_interpret():
    """bf16 X + bf16 diags through the DIA apply: matches the f64 oracle
    to bf16 resolution, output dtype bf16, Gram f32."""
    shape = (16, 16)
    op64 = laplacian_dia(shape, dtype=jnp.float64)
    diags = op64.diags.astype(BF)
    Xt = _field((8, op64.n), 0)
    op = DIAOperator(diags=diags, offsets=op64.offsets)
    Yt, G = op.matmat_gram_t(Xt)
    assert Yt.dtype == BF
    assert G.dtype == jnp.float32
    want = np.asarray(op64.matmat_t(Xt.astype(jnp.float64)))
    got = np.asarray(Yt, np.float64)
    # bf16 eps ~ 7.8e-3; stencil sums 7 terms of O(1)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.15)
    wantG = np.asarray(Xt, np.float64) @ want.T
    np.testing.assert_allclose(np.asarray(G, np.float64), wantG,
                               rtol=0.05, atol=0.5)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
def test_fused_mm2_update_gram_bf16(shape):
    k = shape[0]
    M1, M2 = _kk(k, 1), _kk(k, 2)
    B1, B2 = _field(shape, 3), _field(shape, 4)
    Y, G = f_mm2_update_gram(M1, B1, M2, B2)
    assert Y.dtype == BF
    assert G.dtype == jnp.float32
    b1 = np.asarray(B1, np.float64).reshape(k, -1)
    b2 = np.asarray(B2, np.float64).reshape(k, -1)
    want = np.asarray(M1, np.float64) @ b1 + np.asarray(M2, np.float64) @ b2
    got = np.asarray(Y, np.float64).reshape(k, -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
def test_fused_px_update_bf16(shape):
    k = shape[0]
    M1, rho, C = _kk(k, 5), _kk(k, 6), _kk(k, 7)
    W, P, X = _field(shape, 8), _field(shape, 9), _field(shape, 10)
    Pn, Xn = f_px_update(M1, W, rho, P, C, X)
    assert Pn.dtype == BF and Xn.dtype == BF
    w = np.asarray(W, np.float64).reshape(k, -1)
    p = np.asarray(P, np.float64).reshape(k, -1)
    x = np.asarray(X, np.float64).reshape(k, -1)
    wantP = np.asarray(M1, np.float64) @ w + np.asarray(rho, np.float64) @ p
    wantX = x + np.asarray(C, np.float64) @ p
    np.testing.assert_allclose(np.asarray(Pn, np.float64).reshape(k, -1),
                               wantP, rtol=0, atol=0.05 * np.abs(wantP).max())
    np.testing.assert_allclose(np.asarray(Xn, np.float64).reshape(k, -1),
                               wantX, rtol=0, atol=0.05 * np.abs(wantX).max())


def test_sbcgrq_bf16_fields_converge():
    """SBCGrQ with bf16 state fields (jnp fallback path on CPU): the k x k
    algebra and monitors run f32, so the solve converges to a bf16-limited
    tolerance on a well-conditioned system."""
    shape = (16, 16)
    op = laplacian_dia(shape, dtype=BF)
    assert op.dtype == BF
    rng = np.random.default_rng(11)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=BF)
    X, info = solve_sbcgrq(op, B, tol=2e-2, max_iter=300)
    assert X.dtype == BF
    a = laplacian_scipy(shape)
    Bf = np.asarray(B, np.float64)
    res = np.linalg.norm(a @ np.asarray(X, np.float64) - Bf, axis=0)
    res /= np.linalg.norm(Bf, axis=0)
    assert res.max() <= 5e-2  # true residual at bf16 resolution


def test_cg_bf16_fields_converge():
    """Plain CG with bf16 fields: scalars (rho/alpha/beta/monitor) ride f32
    via acc_dtype while the (1, n) state stays bf16 — regression for the
    while_loop carry dtype mismatch that crashed the bf16 CG preset."""
    from blockcg import solve_cg

    shape = (16, 16)
    op = laplacian_dia(shape, dtype=BF)
    rng = np.random.default_rng(12)
    b = jnp.asarray(rng.standard_normal(op.n), dtype=BF)
    x, info = solve_cg(op, b, tol=2e-2, max_iter=300)
    assert x.dtype == BF
    assert bool(info.converged.all())
    a = laplacian_scipy(shape)
    bf = np.asarray(b, np.float64)
    res = np.linalg.norm(a @ np.asarray(x, np.float64) - bf)
    assert res / np.linalg.norm(bf) <= 5e-2


def test_refined_bf16_inner_f32_outer():
    """The capacity composition for full-size config 5: bf16 inner SBCGrQ
    + f32 outer true-residual refinement reaches 1e-6 (beyond bf16's ~8e-3
    epsilon) — each cycle contracts ~2 digits."""
    shape = (16, 16)
    op = laplacian_dia(shape, dtype=BF)
    rng = np.random.default_rng(12)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    X, info = solve_refined(op, B, tol=1e-6, inner_tol=5e-3,
                            inner_max_iter=400, max_cycles=10,
                            outer_dtype=jnp.float32, qr_passes=1)
    assert X.dtype == jnp.float32
    assert bool(info.converged.all())
    a = laplacian_scipy(shape)
    Bf = np.asarray(B, np.float64)
    res = np.linalg.norm(a @ np.asarray(X, np.float64) - Bf, axis=0)
    res /= np.linalg.norm(Bf, axis=0)
    assert res.max() <= 2e-6


def test_refined_bf16_inner_f64_outer():
    """bf16 inner + default f64 outer: refinement digs well below f32."""
    shape = (12, 12)
    op = laplacian_dia(shape, dtype=BF)
    rng = np.random.default_rng(13)
    B = jnp.asarray(rng.standard_normal((op.n, 3)), dtype=jnp.float32)
    X, info = solve_refined(op, B, tol=1e-9, inner_tol=5e-3,
                            inner_max_iter=400, max_cycles=14, qr_passes=1)
    assert bool(info.converged.all())
    a = laplacian_scipy(shape)
    Bf = np.asarray(B, np.float64)
    res = np.linalg.norm(a @ np.asarray(X, np.float64) - Bf, axis=0)
    res /= np.linalg.norm(Bf, axis=0)
    assert res.max() <= 2e-9


def test_refined_lean_capacity_driver():
    """solve_refined_lean (the full-size-config-5 composition, small scale):
    on-device regenerated B, f32 lanes-major outer accumulator, bf16 inner
    solves on column slices — reaches 1e-6 and matches the direct solve."""
    import scipy.sparse.linalg as spla

    from blockcg.solvers.refine import solve_refined_lean

    shape = (16, 16)
    op = laplacian_dia(shape, dtype=BF)
    key = jax.random.PRNGKey(7)
    k = 8
    X, info = solve_refined_lean(op, key, k, tol=1e-6, inner_tol=5e-3,
                                 inner_max_iter=400, max_cycles=12,
                                 inner_block=4)
    assert X.shape == (op.n, k)
    assert bool(info.converged.all())
    # true residual against the same on-device-generated B
    B = np.asarray(jax.random.normal(key, (k, op.n), jnp.float32)
                   .astype(BF).astype(jnp.float32)).T
    a = laplacian_scipy(shape)
    res = np.linalg.norm(a @ np.asarray(X, np.float64) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-6


def test_refined_lean_deflated(monkeypatch):
    """The capacity driver with converged-column deflation in the inner
    slices (lanes-major width-halving). Must converge to
    the same target as the fixed-width path."""
    from blockcg.solvers.refine import solve_refined_lean

    monkeypatch.setenv("BLOCKCG_DEFLATE_NMIN", "0")  # tiny n: keep halving on
    shape = (16, 16, 4)
    op = laplacian_dia(shape, dtype=BF)
    key = jax.random.PRNGKey(11)
    k = 16
    X, info = solve_refined_lean(op, key, k, tol=1e-6, inner_tol=5e-3,
                                 inner_max_iter=400, max_cycles=12,
                                 inner_block=16, deflate=True,
                                 restart_overhead_s=0.0)
    assert X.shape == (op.n, k)
    assert bool(info.converged.all())
    B = np.asarray(jax.random.normal(key, (k, op.n), jnp.float32)
                   .astype(BF).astype(jnp.float32)).T
    a = laplacian_scipy(shape)
    res = np.linalg.norm(a @ np.asarray(X, np.float64) - B, axis=0)
    res /= np.linalg.norm(B, axis=0)
    assert res.max() <= 2e-6


def test_bf16_fused_kernel_coverage():
    """Every block-update helper on bf16 fields vs a f64 oracle: bf16
    storage, f32 coefficients and Grams."""
    k, n = 8, 512
    rng = np.random.default_rng(31)
    M1 = jnp.asarray(rng.standard_normal((k, k)), jnp.float32)
    M2 = jnp.asarray(rng.standard_normal((k, k)), jnp.float32)
    U = jnp.asarray(rng.standard_normal((k, n)), BF)
    V = jnp.asarray(rng.standard_normal((k, n)), BF)
    X = jnp.asarray(rng.standard_normal((k, n)), BF)
    Uf = np.asarray(U, np.float64)
    Vf = np.asarray(V, np.float64)
    Xf = np.asarray(X, np.float64)
    M1f = np.asarray(M1, np.float64)
    M2f = np.asarray(M2, np.float64)

    def close(got, want, tol=3e-2):
        got = np.asarray(got, np.float64)
        assert np.abs(got - want).max() / (np.abs(want).max() + 1e-30) < tol

    # gram (native bf16 dot is exact in f32 accumulation)
    G = f_gram(U, V)
    close(G, Uf @ Vf.T, 1e-6)
    # mm_update (+A) — coefficient rounds to bf16 (~4e-3)
    Y = f_mm_update(M1, U, X)
    close(Y, M1f @ Uf + Xf)
    assert Y.dtype == BF
    # mm_update_gram: gram taken on the STORED bf16 y
    Y2, G2 = f_mm_update_gram(M1, U, X)
    Y2f = np.asarray(Y2, np.float64)
    close(Y2, M1f @ Uf + Xf)
    close(G2, Y2f @ Y2f.T, 1e-6)
    # mm2_update_gram
    Y3, G3 = f_mm2_update_gram(M1, U, M2, V)
    Y3f = np.asarray(Y3, np.float64)
    close(Y3, M1f @ Uf + M2f @ Vf)
    close(G3, Y3f @ Y3f.T, 1e-6)
    # px_update
    Pn, Xn = f_px_update(M1, U, M2, V, M1, X)
    close(Pn, M1f @ Uf + M2f @ Vf)
    close(Xn, Xf + M1f @ Vf)
    # qr_p_update / qr_px_update
    Q, Pn2 = f_qr_p_update(M2, U, M1, V)
    close(Q, M2f @ Uf)
    close(Pn2, M2f @ Uf + M1f @ Vf)
    Q3, Pn3, Xn3 = f_qr_px_update(M2, U, M1, V, M2, X)
    close(Q3, M2f @ Uf)
    close(Pn3, M2f @ Uf + M1f @ Vf)
    close(Xn3, Xf + M2f @ Vf)
    # xr_update_gram (BCG/BCGA tail)
    Xn4, Rn4, S4 = f_xr_update_gram(M1, U, X, V, X)
    Rn4f = np.asarray(Rn4, np.float64)
    close(Xn4, Xf + M1f @ Uf)
    close(Rn4, Xf - M1f @ Vf)
    close(S4, Rn4f @ Rn4f.T, 1e-5)
