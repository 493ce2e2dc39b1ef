"""Block-update helper tests (solvers/common.py ``f_*``) vs numpy float64.

Each helper is the jnp composition XLA compiles for the solvers' per-
iteration field updates. Shapes cover flat (k, n) fields and the 3D
(k, bs, ns) view; the ``codec`` cases run the merged spin-major layout of a
block operator, whose k x k coefficients expand to I_bs (x) C.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from blockcg.solvers.common import (
    cholqr_fused_t,
    cholqr_t,
    f_gram,
    f_mm2_update_gram,
    f_mm_update,
    f_mm_update_gram,
    f_px_update,
    f_qr_p_update,
    f_qr_px_update,
    f_xr_update_gram,
    qr_factors_from_gram,
    gram_t,
)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)


def _kk(k, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((k, k)), dtype=jnp.float32)


def _f64(a):
    return np.asarray(a, np.float64)


def _mm(m, b):
    """k x k times field in float64 (tensordot over the leading axis)."""
    return np.tensordot(_f64(m), _f64(b), axes=(1, 0))


def _gram(u, v):
    k = u.shape[0]
    return _f64(u).reshape(k, -1) @ _f64(v).reshape(k, -1).T


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512), (12, 4, 256),
                                   (2, (1 << 20) + (1 << 14))])
def test_gram(shape):
    """The last shape is long enough for the chunked partial-Gram sum."""
    U, V = _field(shape, 0), _field(shape, 1)
    G = f_gram(U, V)
    np.testing.assert_allclose(np.asarray(G), _gram(U, V), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
@pytest.mark.parametrize("with_a", [False, True])
def test_mm_update(shape, with_a):
    k = shape[0]
    M, B = _kk(k, 2), _field(shape, 3)
    A = _field(shape, 4) if with_a else None
    Y = f_mm_update(M, B, A)
    want = _mm(M, B)
    if with_a:
        want = want + _f64(A)
    np.testing.assert_allclose(np.asarray(Y), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
@pytest.mark.parametrize("with_a", [False, True])
def test_mm_update_gram(shape, with_a):
    k = shape[0]
    M, B = _kk(k, 5), _field(shape, 6)
    A = _field(shape, 7) if with_a else None
    Y, G = f_mm_update_gram(M, B, A)
    want = _mm(M, B)
    if with_a:
        want = want + _f64(A)
    np.testing.assert_allclose(np.asarray(Y), want, rtol=1e-5, atol=1e-4)
    wantG = want.reshape(k, -1) @ want.reshape(k, -1).T
    np.testing.assert_allclose(np.asarray(G), wantG, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
def test_qr_p_update(shape):
    k = shape[0]
    M2, rho = _kk(k, 8), _kk(k, 9)
    Q1, P = _field(shape, 10), _field(shape, 11)
    Q, Pn = f_qr_p_update(M2, Q1, rho, P)
    wq = _mm(M2, Q1)
    wp = wq + _mm(rho, P)
    np.testing.assert_allclose(np.asarray(Q), wq, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Pn), wp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
def test_mm2_update_gram(shape):
    """Implicit-Q residual-direction update: Y = M1 B1 + M2 B2, G = Y Y^T."""
    k = shape[0]
    M1, M2 = _kk(k, 30), _kk(k, 31)
    B1, B2 = _field(shape, 32), _field(shape, 33)
    Y, G = f_mm2_update_gram(M1, B1, M2, B2)
    want = _mm(M1, B1) + _mm(M2, B2)
    np.testing.assert_allclose(np.asarray(Y), want, rtol=1e-5, atol=1e-4)
    wantG = want.reshape(k, -1) @ want.reshape(k, -1).T
    np.testing.assert_allclose(np.asarray(G), wantG, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
def test_px_update(shape):
    """Implicit-Q iteration tail: Pn = M1 W + rho P, Xn = X + C P (no Q write)."""
    k = shape[0]
    M1, rho, C = _kk(k, 40), _kk(k, 41), _kk(k, 42)
    W, P, X = _field(shape, 43), _field(shape, 44), _field(shape, 45)
    Pn, Xn = f_px_update(M1, W, rho, P, C, X)
    np.testing.assert_allclose(np.asarray(Pn), _mm(M1, W) + _mm(rho, P),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Xn), _f64(X) + _mm(C, P),
                               rtol=1e-5, atol=1e-4)


def test_qr_factors_from_gram_matches_cholqr():
    """qr_factors_from_gram(V V^T) must reproduce _cholqr_once_t's factors."""
    Vt = _field((6, 2048), 12)
    G = gram_t(Vt, Vt)
    M1, R1 = qr_factors_from_gram(G)
    Qt = jnp.tensordot(M1, Vt, axes=(1, 0))
    # V = Q R and Q orthonormal (single f32 pass: modest tolerance)
    rec = np.tensordot(np.asarray(Qt, np.float64), np.asarray(R1, np.float64),
                       axes=(0, 0)).T
    np.testing.assert_allclose(rec, np.asarray(Vt), rtol=1e-3, atol=1e-3)
    QQ = np.asarray(Qt, np.float64) @ np.asarray(Qt, np.float64).T
    assert np.abs(QQ - np.eye(6)).max() < 1e-2


def test_cholqr_fused_matches_cholqr_t():
    """cholqr_fused_t (Gram-deferred passes) == cholqr_t (same math)."""
    Vt = _field((6, 2048), 13)
    Q1, R1 = cholqr_fused_t(Vt, passes=2)
    Q2, R2 = cholqr_t(Vt, passes=2)
    np.testing.assert_allclose(np.asarray(Q1), np.asarray(Q2), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(R1), np.asarray(R2), rtol=2e-4,
                               atol=2e-3)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
def test_qr_px_update(shape):
    k = shape[0]
    M2, rho, C = _kk(k, 20), _kk(k, 21), _kk(k, 22)
    Q1, P, X = _field(shape, 23), _field(shape, 24), _field(shape, 25)
    Q, Pn, Xn = f_qr_px_update(M2, Q1, rho, P, C, X)
    want_q = _mm(M2, Q1)
    np.testing.assert_allclose(np.asarray(Q), want_q, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Pn), want_q + _mm(rho, P),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Xn), _f64(X) + _mm(C, P),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 1024), (6, 4, 512)])
def test_fused_xr_update_gram(shape):
    """Xn = X + aP, Rn = R - aZ, S' = Rn Rn^T (the BCG/BCGA tail) vs the
    f64 oracle."""
    k = shape[0]
    rng = np.random.default_rng(41)
    A = jnp.asarray(rng.standard_normal((k, k)), jnp.float32)
    P = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    X = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    Z = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    R = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    Xn, Rn, S = f_xr_update_gram(A, P, X, Z, R)
    p, x, z, r = (_f64(v).reshape(k, -1) for v in (P, X, Z, R))
    a = _f64(A)
    np.testing.assert_allclose(_f64(Xn).reshape(k, -1), x + a @ p,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f64(Rn).reshape(k, -1), r - a @ z,
                               rtol=1e-5, atol=1e-5)
    rn = _f64(Rn).reshape(k, -1)
    np.testing.assert_allclose(_f64(S), rn @ rn.T, rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ codec cases --
# A block operator's merged (m = bs*k, ns) field: the helpers expand the
# k x k coefficients to I_bs (x) C and contract Grams back to k x k. The
# oracle works on the flat (k, n) fields, where the same update is plain.


def _codec_op():
    from blockcg.problems import dirac_cbdia

    return dirac_cbdia(4, m=0.5, dtype=jnp.float32)  # bs = 4, ns = 256


def _codec_fields(op, k, seeds):
    flat = [jnp.asarray(np.random.default_rng(s).standard_normal((k, op.n)),
                        jnp.float32) for s in seeds]
    return flat, [op.to_internal(f) for f in flat]


@pytest.mark.parametrize("k", [2, 3])
def test_codec_mm_update_gram(k):
    op = _codec_op()
    (B, A), (Bm, Am) = _codec_fields(op, k, (50, 51))
    M = _kk(k, 52)
    Ym, G = f_mm_update_gram(M, Bm, Am, codec=op)
    want = _f64(M) @ _f64(B) + _f64(A)
    np.testing.assert_allclose(_f64(op.from_internal(Ym)), want, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(_f64(G), want @ want.T, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("k", [2, 3])
def test_codec_mm2_and_px_update(k):
    op = _codec_op()
    (W, Z, P, X), (Wm, Zm, Pm, Xm) = _codec_fields(op, k, (60, 61, 62, 63))
    M1, M2, rho, C = _kk(k, 64), _kk(k, 65), _kk(k, 66), _kk(k, 67)
    Vm, G = f_mm2_update_gram(M1, Wm, M2, Zm, codec=op)
    want_v = _f64(M1) @ _f64(W) + _f64(M2) @ _f64(Z)
    np.testing.assert_allclose(_f64(op.from_internal(Vm)), want_v,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_f64(G), want_v @ want_v.T, rtol=1e-4,
                               atol=1e-2)
    Pn, Xn = f_px_update(M1, Wm, rho, Pm, C, Xm, codec=op)
    np.testing.assert_allclose(_f64(op.from_internal(Pn)),
                               _f64(M1) @ _f64(W) + _f64(rho) @ _f64(P),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_f64(op.from_internal(Xn)),
                               _f64(X) + _f64(C) @ _f64(P),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [2, 3])
def test_codec_xr_and_qr_updates(k):
    op = _codec_op()
    (P, X, Z, R), (Pm, Xm, Zm, Rm) = _codec_fields(op, k, (70, 71, 72, 73))
    A, rho = _kk(k, 74), _kk(k, 75)
    Xn, Rn, S = f_xr_update_gram(A, Pm, Xm, Zm, Rm, codec=op)
    want_r = _f64(R) - _f64(A) @ _f64(Z)
    np.testing.assert_allclose(_f64(op.from_internal(Xn)),
                               _f64(X) + _f64(A) @ _f64(P),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_f64(op.from_internal(Rn)), want_r,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_f64(S), want_r @ want_r.T, rtol=1e-4,
                               atol=1e-2)
    Q, Pn = f_qr_p_update(A, Rm, rho, Pm, codec=op)
    np.testing.assert_allclose(_f64(op.from_internal(Q)), _f64(A) @ _f64(R),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        _f64(op.from_internal(Pn)),
        _f64(A) @ _f64(R) + _f64(rho) @ _f64(P), rtol=1e-5, atol=1e-4)
