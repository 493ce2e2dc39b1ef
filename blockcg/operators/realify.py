"""Realified Hermitian operators — complex systems solved in real arithmetic.

The reference solves complex Hermitian systems directly (Eigen complex
matrices, SURVEY.md §1), and so can this library: every solver is
conjugate-correct on complex64/complex128 fields. This module offers the
other route, the standard isomorphism

    A x = b   (A Hermitian)   <=>   A_R [re x; im x] = [re b; im b],
    A_R = [[Re A, -Im A], [Im A, Re A]]   (A_R real SYMMETRIC, SPD iff A HPD)

and runs the *real* solvers on stacked (re, im) fields. For block lattice
operators the stacking rides the spin axis (bs -> 2 bs), so a complex
Dirac-like operator is just a ConstBlockDIA with doubled hop blocks.

``RealifiedHermitianOperator`` is a drop-in LinearOperator: its public
``matmat`` / ``matmat_t`` speak complex, its ``to_internal``/``from_internal``
hooks hand the solvers real stacked fields, so ``solve_sbcgrq(realify(op), B)``
with complex ``B`` runs the entire hot loop in real arithmetic.

Note on Krylov spaces: this solves the real 2n-dimensional system — the
spectrum of A_R is that of A with doubled multiplicity (same condition
number), so CG-family iteration counts match the complex solve; the subtle
difference is that real-block solvers cannot rotate by complex phases inside
the k x k coefficients, which in practice costs at most a few iterations.
The true-complex solvers (conjugate-correct, XLA complex64) remain available
by passing the complex operator directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from blockcg.operators.base import MatmatMixin


def _doubled_block(h: np.ndarray) -> np.ndarray:
    """bs x bs complex -> 2bs x 2bs real [[Hr, -Hi], [Hi, Hr]]."""
    hr, hi = h.real, h.imag
    return np.block([[hr, -hi], [hi, hr]])


def real_mask_dtype(np_dtype) -> np.dtype:
    """Real dtype matching a complex one's width (mask/value arrays)."""
    return np.float32 if np.dtype(np_dtype) == np.complex64 else np.float64


def k1k2_blocks(B: np.ndarray, rdt) -> tuple[np.ndarray, np.ndarray]:
    """Canonical realified split of a complex-scaled block:
    ``phi * B = phi_r * K1(B) + phi_i * K2(B)`` with
    K1 = [[Br, -Bi], [Bi, Br]] and K2 = [[-Bi, -Br], [Br, -Bi]] —
    the single source of truth for U(1)-gauged value-masked operators
    (problems/dirac.py and problems/dirac_eo.py both build from this)."""
    br, bi = B.real.astype(rdt), B.imag.astype(rdt)
    return (np.block([[br, -bi], [bi, br]]),
            np.block([[-bi, -br], [br, -bi]]))


@dataclasses.dataclass
class RealifiedHermitianOperator(MatmatMixin):
    """Complex Hermitian operator realized as a real symmetric one.

    ``real_op`` acts on stacked fields; ``cbs`` is the complex spin-block
    size (0 for unstructured/dense: stacking is then along flat rows)."""

    real_op: object
    cbs: int
    num_sites: int
    cdtype: jnp.dtype

    @property
    def n(self) -> int:
        return max(self.cbs, 1) * self.num_sites

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return getattr(self, "_nnz", self.real_op.nnz)

    @property
    def dtype(self):
        return self.cdtype

    # -- field codecs: complex (k, n) <-> real stacked internal view --------

    def _rdtype(self):
        return jnp.float32 if self.cdtype == jnp.complex64 else jnp.float64

    def to_internal(self, Xt) -> jax.Array:
        """Complex (k, n) -> the real op's internal view of the stacked
        real field. Stacking rides the spin axis (spins [0, cbs) carry Re,
        [cbs, 2cbs) carry Im, matching the doubled hop blocks
        [[Hr, -Hi], [Hi, Hr]]); the real op then applies its own internal
        layout (merged spin-major for the const-hop operator)."""
        k = Xt.shape[0]
        if self.cbs > 0:
            Xv = Xt.reshape(k, self.cbs, self.num_sites)
            flat = jnp.concatenate([jnp.real(Xv), jnp.imag(Xv)], axis=1)
            flat = flat.reshape(k, 2 * self.cbs * self.num_sites)
        else:
            flat = jnp.concatenate([jnp.real(Xt), jnp.imag(Xt)], axis=1)
        return self.real_op.to_internal(flat.astype(self._rdtype()))

    def from_internal(self, Xf):
        Xs = self.real_op.from_internal(Xf)
        k = Xs.shape[0]
        if self.cbs > 0:
            Xv = Xs.reshape(k, 2 * self.cbs, self.num_sites)
            re, im = Xv[:, : self.cbs, :], Xv[:, self.cbs :, :]
            return (re + 1j * im.astype(re.dtype)).reshape(k, self.n).astype(
                self.cdtype
            )
        return (Xs[:, : self.n] + 1j * Xs[:, self.n :]).astype(self.cdtype)

    def coeff_expand(self, C):
        return self.real_op.coeff_expand(C)

    def gram_contract(self, G):
        return self.real_op.gram_contract(G)

    def norms2_contract(self, v):
        return self.real_op.norms2_contract(v)

    def astype_op(self, dtype):
        """Width change (operators.base.astype hook): the wrapper's width
        lives in ``cdtype`` (meta), so tree_map alone cannot widen it —
        rebuild with the real core cast and cdtype matched."""
        from blockcg.operators.base import astype as _astype

        dtype = jnp.dtype(dtype)
        wide = dtype.itemsize >= 8  # f64 or c128 request -> c128
        cdt = jnp.complex128 if wide else jnp.complex64
        rdt = jnp.float64 if wide else jnp.float32
        w = RealifiedHermitianOperator(
            real_op=_astype(self.real_op, rdt),
            cbs=self.cbs,
            num_sites=self.num_sites,
            cdtype=cdt,
        )
        if hasattr(self, "_nnz"):
            object.__setattr__(w, "_nnz", self._nnz)
        return w

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        if jnp.issubdtype(Xt.dtype, jnp.complexfloating):
            # Public complex boundary: encode, apply real, decode.
            return self.from_internal(self.real_op.matmat_t(self.to_internal(Xt)))
        # Solver-internal stacked real field: straight through.
        return self.real_op.matmat_t(Xt)


jax.tree_util.register_dataclass(
    RealifiedHermitianOperator,
    data_fields=["real_op"],
    meta_fields=["cbs", "num_sites", "cdtype"],
)


def realify(op) -> RealifiedHermitianOperator:
    """Build the real symmetric form of a complex Hermitian operator.

    Supports ConstBlockDIAOperator (hop doubling — stays a const-hop
    operator), BlockDIAOperator (per-site block doubling), and
    DenseOperator. The input must be Hermitian; realify does not check."""
    from blockcg.operators.bdia import BlockDIAOperator
    from blockcg.operators.cbdia import ConstBlockDIAOperator
    from blockcg.operators.dense import DenseOperator

    if isinstance(op, ConstBlockDIAOperator):
        hops2 = []
        for h in op.hops:
            hm = np.asarray(h, dtype=np.complex128)
            big = _doubled_block(hm)
            hops2.append(tuple(tuple(float(v) for v in row) for row in big))
        masks = op.masks
        rdt = jnp.float32 if masks is None or masks.dtype == jnp.float32 \
            else jnp.float64
        real_op = ConstBlockDIAOperator(
            masks=masks,
            hops=tuple(hops2),
            offsets=op.offsets,
            mask_slot=op.mask_slot,
            num_sites=op.num_sites,
        )
        cdtype = jnp.complex64 if rdt == jnp.float32 else jnp.complex128
        w = RealifiedHermitianOperator(
            real_op=real_op, cbs=op.bs, num_sites=op.num_sites, cdtype=cdtype
        )
        object.__setattr__(w, "_nnz", op.nnz)
        return w

    if isinstance(op, BlockDIAOperator):
        blocks = np.asarray(jax.device_get(op.blocks))
        noff, bs, _, ns = blocks.shape
        rdt = np.float32 if blocks.dtype == np.complex64 else np.float64
        out = np.empty((noff, 2 * bs, 2 * bs, ns), dtype=rdt)
        br, bi = blocks.real.astype(rdt), blocks.imag.astype(rdt)
        out[:, :bs, :bs] = br
        out[:, :bs, bs:] = -bi
        out[:, bs:, :bs] = bi
        out[:, bs:, bs:] = br
        real_op = BlockDIAOperator(blocks=jnp.asarray(out), offsets=op.offsets)
        object.__setattr__(real_op, "_nnz", int(np.count_nonzero(out)))
        cdt = jnp.complex64 if rdt == np.float32 else jnp.complex128
        w = RealifiedHermitianOperator(
            real_op=real_op, cbs=bs, num_sites=ns, cdtype=cdt
        )
        object.__setattr__(w, "_nnz", op.nnz)
        return w

    if isinstance(op, DenseOperator):
        A = np.asarray(jax.device_get(op.A))
        n = A.shape[0]
        rdt = np.float32 if A.dtype == np.complex64 else np.float64
        Ar = np.block([[A.real, -A.imag], [A.imag, A.real]]).astype(rdt)
        real_op = DenseOperator(A=jnp.asarray(Ar))
        cdt = jnp.complex64 if rdt == np.float32 else jnp.complex128
        w = RealifiedHermitianOperator(
            real_op=real_op, cbs=0, num_sites=n, cdtype=cdt
        )
        object.__setattr__(w, "_nnz", int(np.count_nonzero(A)))
        return w

    raise TypeError(f"realify: unsupported operator type {type(op).__name__}")
