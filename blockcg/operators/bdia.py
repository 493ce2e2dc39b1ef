"""Block-DIA operator: per-site bs x bs blocks on static site offsets.

The representation of nearest-neighbor lattice block operators with
site-dependent blocks (gauged and matrix-link Dirac-like operators; reference
R1 BSR flavor, SURVEY.md §3.1). Compared to generic BSR it drops the
column-index arrays entirely (offsets are static structure): ~4 B/nnz of
matrix traffic.

Row ordering is spin-major: row = a * ns + s (a = block/spin index,
s = site). Periodic wraps are separate masked diagonals (see
problems/dirac.py), so all structure is static.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class BlockDIAOperator(MatmatMixin):
    """blocks: (noff, bs, bs, ns); offsets: static site offsets.

    ``blocks[d, a, b, s]`` couples row (a, s) to column
    (b, (s + offsets[d]) mod ns) — semantics are toroidal. Builders zero
    slots with no true coupling.
    """

    blocks: jax.Array
    offsets: tuple[int, ...]

    @property
    def bs(self) -> int:
        return self.blocks.shape[1]

    @property
    def ns(self) -> int:
        return self.blocks.shape[3]

    @property
    def n(self) -> int:
        return self.bs * self.ns

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return getattr(
            self, "_nnz", self.blocks.shape[0] * self.bs * self.bs * self.ns
        )

    @property
    def dtype(self):
        return self.blocks.dtype

    def to_internal(self, Xt: jax.Array) -> jax.Array:
        """Flat lanes-major (k, bs*ns) -> merged spin-major (m = bs*k, ns)
        (see operators/cbdia.py)."""
        k = Xt.shape[0]
        Xv = Xt.reshape(k, self.bs, self.ns)
        return jnp.swapaxes(Xv, 0, 1).reshape(self.bs * k, self.ns)

    def from_internal(self, Xm: jax.Array) -> jax.Array:
        k = Xm.shape[0] // self.bs
        Xv = Xm.reshape(self.bs, k, self.ns)
        return jnp.swapaxes(Xv, 0, 1).reshape(k, self.n)

    def coeff_expand(self, C):
        return jnp.kron(jnp.eye(self.bs, dtype=C.dtype), C)

    def gram_contract(self, G):
        k = G.shape[0] // self.bs
        return jnp.einsum("aiaj->ij", G.reshape(self.bs, k, self.bs, k))

    def norms2_contract(self, v):
        return v.reshape(self.bs, -1).sum(axis=0)

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        """Apply to a lanes-major block: merged internal (m, ns), flat
        (k, bs*ns), or the 3D (k, bs, ns) view (used by the distributed
        wrapper's local shards)."""
        if Xt.ndim == 2 and Xt.shape[-1] == self.ns:  # merged internal
            return self._matmat_m(Xt)
        flat = Xt.ndim == 2
        Xv = Xt.reshape(Xt.shape[0], self.bs, self.ns) if flat else Xt
        Yv = self._matmat_v(Xv)
        return Yv.reshape(Yv.shape[0], self.n) if flat else Yv

    def _matmat_m(self, Xm: jax.Array) -> jax.Array:
        from blockcg.solvers.common import acc_dtype

        m, ns = Xm.shape
        bs = self.bs
        k = m // bs
        adt = acc_dtype(Xm.dtype)  # bf16 fields accumulate in f32
        Xv = Xm.reshape(bs, k, ns)
        Yv = jnp.zeros((bs, k, ns), dtype=adt)
        for d, o in enumerate(self.offsets):  # static unroll
            src = Xv if o == 0 else jnp.roll(Xv, -o, axis=2)
            Yv = Yv + jnp.einsum(
                "abi,bki->aki", self.blocks[d].astype(adt), src.astype(adt),
                precision=jax.lax.Precision.HIGHEST,
            )
        return Yv.reshape(m, ns).astype(Xm.dtype)

    def _matmat_v(self, Xv: jax.Array) -> jax.Array:
        # Toroidal semantics: site = (s + o) mod ns.
        k = Xv.shape[0]
        bs, ns = self.bs, self.ns
        Yv = jnp.zeros((k, bs, ns), dtype=Xv.dtype)
        for d, o in enumerate(self.offsets):  # static unroll
            src = Xv if o == 0 else jnp.roll(Xv, -o, axis=2)
            # Y[k, a, i] += sum_b blocks[d, a, b, i] * src[k, b, i]
            Yv = Yv + jnp.einsum(
                "abi,kbi->kai", self.blocks[d], src,
                precision=jax.lax.Precision.HIGHEST,
            )
        return Yv


jax.tree_util.register_dataclass(
    BlockDIAOperator,
    data_fields=["blocks"],
    meta_fields=["offsets"],
)
