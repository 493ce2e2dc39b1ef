"""BSR operator in block-ELL layout (fixed blocks-per-block-row).

Reference equivalent: R1 (SURVEY.md §3.1), BSR flavor — the lattice-Dirac-like
operator of north-star config 4 is 4x4-blocked. Layout:

  vals: (nbr, wb, bs, bs)  dense blocks, padded block slots are exactly 0
  cols: (nbr, wb)          block-column indices; padded slots point at the
                           block row itself (safe local gather)

where nbr = n/bs block rows and wb = max blocks per block row. Fixed wb makes
every shape static, which is what XLA needs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class BSROperator(MatmatMixin):
    vals: jax.Array  # (nbr, wb, bs, bs)
    cols: jax.Array  # (nbr, wb) int32

    @property
    def bs(self) -> int:
        return self.vals.shape[-1]

    @property
    def nbr(self) -> int:
        return self.vals.shape[0]

    @property
    def wb(self) -> int:
        return self.vals.shape[1]

    @property
    def n(self) -> int:
        return self.nbr * self.bs

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return getattr(self, "_nnz", self.nbr * self.wb * self.bs * self.bs)

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, a, bs: int, dtype=jnp.float32) -> "BSROperator":
        a = a.tobsr(blocksize=(bs, bs))
        nbr = a.shape[0] // bs
        counts = np.diff(a.indptr)
        wb = int(counts.max())
        np_dtype = np.dtype(jnp.dtype(dtype).name)
        vals = np.zeros((nbr, wb, bs, bs), dtype=np_dtype)
        cols = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, wb))
        for i in range(nbr):
            lo, hi = a.indptr[i], a.indptr[i + 1]
            vals[i, : hi - lo] = a.data[lo:hi]
            cols[i, : hi - lo] = a.indices[lo:hi]
        op = cls(vals=jnp.asarray(vals), cols=jnp.asarray(cols))
        object.__setattr__(op, "_nnz", int(np.count_nonzero(a.data)))
        return op

    def matmat(self, X: jax.Array) -> jax.Array:
        """XLA path: per-slot block gather + batched (bs,bs)@(bs,k) matmul."""
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        n, k = X.shape
        assert n == self.n, (n, self.n)
        Xb = X.reshape(self.nbr, self.bs, k)
        Y = jnp.zeros((self.nbr, self.bs, k), dtype=X.dtype)
        for j in range(self.wb):  # wb is small and static: unrolled under jit
            xg = Xb[self.cols[:, j]]  # (nbr, bs, k)
            Y = Y + jax.lax.dot_general(
                self.vals[:, j],
                xg,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=X.dtype,
                precision=jax.lax.Precision.HIGHEST,
            )
        Y = Y.reshape(n, k)
        return Y[:, 0] if squeeze else Y

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        """(k, n) lanes-major apply."""
        k, n = Xt.shape
        assert n == self.n, (n, self.n)
        Xb = Xt.reshape(k, self.nbr, self.bs)
        Yb = jnp.zeros((k, self.nbr, self.bs), dtype=Xt.dtype)
        for j in range(self.wb):
            xg = Xb[:, self.cols[:, j], :]  # (k, nbr, bs)
            # Y[k, i, a] += sum_b vals[i, j, a, b] * xg[k, i, b]
            Yb = Yb + jax.lax.dot_general(
                xg,
                self.vals[:, j],
                dimension_numbers=(((2,), (2,)), ((1,), (0,))),
                preferred_element_type=Xt.dtype,
                precision=jax.lax.Precision.HIGHEST,
            ).transpose(1, 0, 2)
        return Yb.reshape(k, n)


jax.tree_util.register_dataclass(
    BSROperator,
    data_fields=["vals", "cols"],
    meta_fields=[],
)
