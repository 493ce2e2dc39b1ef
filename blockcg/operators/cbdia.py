"""Constant-hop Block-DIA operator: site-independent bs x bs blocks on
static site offsets, with per-site 0/1 boundary masks.

The speed-of-light container for translation-invariant lattice block
operators (north-star config 4; reference R1 BSR flavor, SURVEY.md §3.1):
the hop blocks live in the *program* (compile-time scalars — zero matrix
traffic), only boundary masks (4 B/site per masked diagonal) stream from
HBM. Semantics match BlockDIAOperator:

    A[(a, s), (b, (s + offsets[d]) mod ns)] = hops[d][a][b] * mask_d[s]

with ``mask_d = 1`` for unmasked diagonals (mask_slot[d] == -1). Row
ordering is spin-major: row = a * ns + s.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class ConstBlockDIAOperator(MatmatMixin):
    """masks: (nmask, ns) 0/1 row gates or None; hops/offsets/mask_slot are
    static structure (hops as nested tuples of Python floats)."""

    masks: jax.Array | None
    hops: tuple  # (noff)(bs)(bs) floats
    offsets: tuple[int, ...]
    mask_slot: tuple[int, ...]
    num_sites: int

    @property
    def bs(self) -> int:
        return len(self.hops[0])

    @property
    def ns(self) -> int:
        return self.num_sites

    @property
    def n(self) -> int:
        return self.bs * self.num_sites

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return getattr(
            self, "_nnz", len(self.offsets) * self.bs * self.bs * self.num_sites
        )

    @property
    def dtype(self):
        mdt = jnp.float32 if self.masks is None else self.masks.dtype
        if any(
            isinstance(v, complex) and v.imag != 0.0
            for h in self.hops for row in h for v in row
        ):
            return jnp.complex64 if mdt == jnp.float32 else jnp.complex128
        return mdt

    def to_internal(self, Xt: jax.Array) -> jax.Array:
        """Flat lanes-major (k, bs*ns) [spin-major rows a*ns + s] -> merged
        spin-major internal (m, ns), m = bs*k, row = a*k + i.

        One physical transpose per solve entry — the hot loop is
        relayout-free."""
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
        """Apply to a lanes-major block: flat (k, n) [spin-major rows], the
        merged internal (m, ns) view, or the 3D (k, bs, ns) view."""
        if Xt.ndim == 3:  # 3D view: convert through merged
            k = Xt.shape[0]
            Xm = jnp.swapaxes(Xt, 0, 1).reshape(self.bs * k, self.ns)
            Ym = self._matmat_m(Xm)
            return jnp.swapaxes(Ym.reshape(self.bs, k, self.ns), 0, 1)
        if Xt.shape[-1] != self.ns:  # flat (k, n)
            return self.from_internal(self._matmat_m(self.to_internal(Xt)))
        return self._matmat_m(Xt)

    def matmat_gram_t(self, Xt: jax.Array):
        """(Y, k x k Gram); a flat (k, n) input converts through the merged
        view, whose (m, m) Gram the codec contracts."""
        if Xt.ndim == 2 and Xt.shape[-1] != self.ns:
            Ym, G = super().matmat_gram_t(self.to_internal(Xt))
            return self.from_internal(Ym), G
        return super().matmat_gram_t(Xt)

    def _matmat_m(self, Xm: jax.Array) -> jax.Array:
        m, ns = Xm.shape
        bs = self.bs
        k = m // bs
        Xv = Xm.reshape(bs, k, ns)
        H = jnp.asarray(self.hops, dtype=Xm.dtype)  # (noff, bs, bs)
        Yv = jnp.zeros((bs, k, ns), dtype=Xm.dtype)
        for d, o in enumerate(self.offsets):  # static unroll
            src = Xv if o == 0 else jnp.roll(Xv, -o, axis=2)
            t = jnp.einsum(
                "ab,bki->aki", H[d], src, precision=jax.lax.Precision.HIGHEST
            )
            if self.mask_slot[d] >= 0:
                t = t * self.masks[self.mask_slot[d]][None, None, :].astype(Xm.dtype)
            Yv = Yv + t
        return Yv.reshape(m, ns)

    def to_block_dia(self):
        """Materialize as a general BlockDIAOperator (tests / oracles)."""
        from blockcg.operators.bdia import BlockDIAOperator

        import numpy as np

        bs, ns = self.bs, self.ns
        cplx = any(
            isinstance(v, complex) and v.imag != 0.0
            for h in self.hops for row in h for v in row
        )
        if self.masks is None:
            dtype = np.complex64 if cplx else np.float32
        else:
            mdt = np.dtype(self.masks.dtype.name)
            if cplx:
                dtype = np.complex64 if mdt == np.float32 else np.complex128
            else:
                dtype = mdt
        masks_np = None if self.masks is None else np.asarray(jax.device_get(self.masks))
        blocks = np.empty((len(self.offsets), bs, bs, ns), dtype=dtype)
        for d in range(len(self.offsets)):
            h = np.asarray(self.hops[d], dtype=dtype)
            m = (
                np.ones(ns, dtype=dtype)
                if self.mask_slot[d] < 0
                else masks_np[self.mask_slot[d]].astype(dtype)
            )
            blocks[d] = h[:, :, None] * m[None, None, :]
        op = BlockDIAOperator(blocks=jnp.asarray(blocks), offsets=self.offsets)
        object.__setattr__(op, "_nnz", int(np.count_nonzero(blocks)))
        return op


jax.tree_util.register_dataclass(
    ConstBlockDIAOperator,
    data_fields=["masks"],
    meta_fields=["hops", "offsets", "mask_slot", "num_sites"],
)

