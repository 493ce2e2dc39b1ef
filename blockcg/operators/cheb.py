"""Chebyshev polynomial preconditioning (beyond the reference).

For SPD/HPD A with spectrum inside [lo, hi], the Chebyshev semi-iteration
of fixed degree d defines M = p_d(A) ~ A^{-1} with p_d > 0 on [lo, hi]
(Saad, Iterative Methods, §12.3). Since M is a polynomial in A it COMMUTES
with A, so M A is itself SPD/HPD and the preconditioned system

    (M A) X = M B        (same solution X)

can be handed to the UNMODIFIED block solvers — preconditioning becomes an
operator wrapper, no solver surgery. Each preconditioned apply costs d
SpMMs + (d-1) Chebyshev field updates; iteration counts drop ~d-fold, which
pays off whenever the per-iteration k x k/QR/update chain (not the SpMM)
dominates.

The solver's convergence monitor sees the PRECONDITIONED residual;
solvers/poly.py wraps the solve in a true-residual outer loop.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from blockcg.operators.base import MatmatMixin


def _cheb_m_apply(base, Rt, lo, hi, degree: int):
    """z = p_d(A) r — d-step Chebyshev semi-iteration for A z = r, z0 = 0.

    Scalar recurrence per Saad Alg. 12.1."""

    rdt = jnp.real(Rt).dtype
    theta = (hi + lo).astype(rdt) / 2
    delta = (hi - lo).astype(rdt) / 2
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    z = Rt / theta
    dlt = z
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        Az = base.matmat_t(z)
        # dlt' = rho_new*rho*dlt + (2 rho_new/delta) (r - A z);  z' = z + dlt'
        c1 = rho_new * rho
        c2 = 2.0 * rho_new / delta
        dlt = c1 * dlt + c2 * (Rt - Az)
        z = z + dlt
        rho = rho_new
    return z


@dataclasses.dataclass
class ChebyshevOperator(MatmatMixin):
    """M A with M = p_degree(A), spectrum bounds carried as array leaves
    (re-estimating bounds does not retrace)."""

    base: object
    lo: jax.Array
    hi: jax.Array
    degree: int

    @property
    def shape(self):
        return self.base.shape

    @property
    def n(self):
        return self.base.shape[0]

    @property
    def nnz(self) -> int:
        return self.base.nnz * self.degree  # SpMMs per preconditioned apply

    @property
    def dtype(self):
        return self.base.dtype

    def to_internal(self, Xt):
        return self.base.to_internal(Xt)

    def from_internal(self, Xv):
        return self.base.from_internal(Xv)

    def coeff_expand(self, C):
        return self.base.coeff_expand(C)

    def gram_contract(self, G):
        return self.base.gram_contract(G)

    def norms2_contract(self, v):
        return self.base.norms2_contract(v)

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        return self.apply_m_t(self.base.matmat_t(Xt))

    def apply_m_t(self, Rt: jax.Array) -> jax.Array:
        """M r (lanes-major field) — used for the right-hand-side transform."""
        return _cheb_m_apply(self.base, Rt, self.lo, self.hi, self.degree)


jax.tree_util.register_dataclass(
    ChebyshevOperator, data_fields=["base", "lo", "hi"], meta_fields=["degree"]
)


def estimate_spectrum(op, iters: int = 30, seed: int = 0, safety: float = 1.05):
    """(lo, hi) bounds on the spectrum of SPD ``op`` by power iteration on A
    (for hi) and on hi*I - A (for lo). One jitted fori_loop each."""
    import functools

    import numpy as np

    @functools.partial(jax.jit, static_argnames=("iters", "flip"))
    def power(op, v0, shift, iters, flip):
        def body(i, v):
            w = op.matmat_t(v)
            if flip:
                w = shift * v - w
            nrm = jnp.sqrt(jnp.sum(jnp.real(w * jnp.conj(w))))
            return w / jnp.maximum(nrm, 1e-30)
        v = jax.lax.fori_loop(0, iters, body, v0)
        w = op.matmat_t(v)
        if flip:
            w = shift * v - w
        num = jnp.sum(jnp.real(jnp.conj(v) * w))
        den = jnp.sum(jnp.real(v * jnp.conj(v)))
        return num / den

    rng = np.random.default_rng(seed)
    if jnp.issubdtype(jnp.dtype(op.dtype), jnp.complexfloating):
        v = rng.standard_normal((1, op.shape[0])) + 1j * rng.standard_normal(
            (1, op.shape[0])
        )
    else:
        v = rng.standard_normal((1, op.shape[0]))
    v0 = op.to_internal(jnp.asarray(v, dtype=op.dtype))
    zero = jnp.asarray(0.0, jnp.real(v0).dtype)
    hi = power(op, v0, zero, iters, False) * safety
    gap = power(op, v0, hi, iters, True)  # ~ hi - lambda_min
    lo = jnp.maximum((hi - gap) / safety, hi * 1e-6)
    return lo, hi
