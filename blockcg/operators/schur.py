"""Even-odd (red-black) Schur-complement operator — lattice preconditioning.

The standard lattice-QCD acceleration (the reference's operator class is the
"even-odd-preconditioned Wilson" form, SURVEY.md §1/R10): a nearest-neighbor
operator couples only opposite parities, so in even/odd ordering

    A = [[c I, -H_eo], [-H_oe, c I]],     c = m^2 + 2*ndim

and solving A X = B reduces to the HALF-SIZE Schur system on even sites

    S_e x_e = b_e + H_eo b_o / c,   S_e = c I - H_eo H_oe / c
    x_o     = (b_o + H_oe x_e) / c

S_e is SPD/HPD with kappa(S_e) ~ kappa(A)^... (roughly halved condition
number) — iteration counts drop ~2x and every per-iteration field is half
sized. The parity hops H_eo/H_oe are themselves constant-hop block stencils
on the half lattice (problems/dirac.py builds them with auto-derived
offset/mask groups), so the const-hop apply and its distribution apply.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class SchurEvenOperator(MatmatMixin):
    """S_e = c I - hop_eo @ hop_oe / c on even-parity half fields.

    hop_oe maps an even half field to odd rows; hop_eo maps odd to even.
    Both are ConstBlockDIAOperator instances on the half lattice."""

    hop_eo: object
    hop_oe: object
    c: float

    @property
    def bs(self) -> int:
        return self.hop_oe.bs

    @property
    def ns(self) -> int:
        return self.hop_oe.ns

    @property
    def n(self) -> int:
        return self.hop_oe.n

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        # One S_e apply touches every entry of both hops plus the diagonal.
        return getattr(self, "_nnz", self.hop_eo.nnz + self.hop_oe.nnz + self.n)

    @property
    def dtype(self):
        return self.hop_oe.dtype

    def to_internal(self, Xt: jax.Array) -> jax.Array:
        return self.hop_oe.to_internal(Xt)

    def from_internal(self, Xv: jax.Array) -> jax.Array:
        return self.hop_oe.from_internal(Xv)

    def coeff_expand(self, C):
        return self.hop_oe.coeff_expand(C)

    def gram_contract(self, G):
        return self.hop_oe.gram_contract(G)

    def norms2_contract(self, v):
        return self.hop_oe.norms2_contract(v)

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        c = jnp.asarray(self.c, dtype=jnp.real(Xt).dtype)
        return c * Xt - self.hop_eo.matmat_t(self.hop_oe.matmat_t(Xt)) / c


jax.tree_util.register_dataclass(
    SchurEvenOperator,
    data_fields=["hop_eo", "hop_oe"],
    meta_fields=["c"],
)


@dataclasses.dataclass
class EONormalOperator(MatmatMixin):
    """``mu I - H_eo H_oe`` on even-parity half fields — the shift-invariant
    base operator of the MULTI-SHIFT even-odd reduction.

    The shifted full systems (A + sigma) X = B reduce on the evens to
    ((c+sigma)^2 - H_eo H_oe) x_e = (c+sigma) b_e + H_eo b_o: every shift
    shares the operator K = H_eo H_oe, so with mu = (c+sigma_min)^2 this
    SPD operator seeds one block-Krylov space for ALL shifts
    (problems.dirac_eo.solve_dirac_eo_shifted); note S_e(sigma) =
    (mu_sigma - K)/(c+sigma) — same matrix scaled, so conditioning equals
    the plain even-odd Schur system's."""

    hop_eo: object
    hop_oe: object
    mu: float

    @property
    def bs(self) -> int:
        return self.hop_oe.bs

    @property
    def ns(self) -> int:
        return self.hop_oe.ns

    @property
    def n(self) -> int:
        return self.hop_oe.n

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return getattr(self, "_nnz", self.hop_eo.nnz + self.hop_oe.nnz + self.n)

    @property
    def dtype(self):
        return self.hop_oe.dtype

    def to_internal(self, Xt):
        return self.hop_oe.to_internal(Xt)

    def from_internal(self, Xv):
        return self.hop_oe.from_internal(Xv)

    def coeff_expand(self, C):
        return self.hop_oe.coeff_expand(C)

    def gram_contract(self, G):
        return self.hop_oe.gram_contract(G)

    def norms2_contract(self, v):
        return self.hop_oe.norms2_contract(v)

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        mu = jnp.asarray(self.mu, dtype=jnp.real(Xt).dtype)
        return mu * Xt - self.hop_eo.matmat_t(self.hop_oe.matmat_t(Xt))


jax.tree_util.register_dataclass(
    EONormalOperator,
    data_fields=["hop_eo", "hop_oe"],
    meta_fields=["mu"],
)
