"""DIA (diagonal / banded) operator.

For stencil matrices (the north-star Laplacian configs) DIA carries no column
indices at all (~4 B/nnz of matrix traffic vs ~8 for CSR), and the "gather"
becomes a static shift, which XLA compiles to contiguous reads that it fuses
into one loop over the diagonals. SURVEY.md §7 roofline.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class DIAOperator(MatmatMixin):
    """offsets: static tuple of ints; diags: (ndiag, n).

    ``diags[d, i]`` multiplies ``X[i + offsets[d]]`` into ``Y[i]`` (row-major
    convention: diags are stored aligned to the *row* index). Out-of-range
    entries of a diagonal are zero by construction.
    """

    diags: jax.Array
    offsets: tuple[int, ...]

    @property
    def n(self) -> int:
        return self.diags.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        """Structural nonzeros. Default assumes TRUNCATED diagonals
        (n - |o| entries each — correct for the Dirichlet constructors);
        toroidal operators whose wrap entries are populated should set
        ``_nnz`` (builders do) or throughput metrics undercount."""
        n = self.n
        return getattr(
            self, "_nnz", sum(n - abs(o) for o in self.offsets)
        )

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets)

    @property
    def dtype(self):
        return self.diags.dtype

    @classmethod
    def from_scipy(cls, a, dtype=jnp.float32) -> "DIAOperator":
        a = a.todia()
        offsets = tuple(int(o) for o in a.offsets)
        n = a.shape[0]
        # scipy DIA aligns data to the *column* index: data[d, j] is A[j-o, j].
        # Re-align to rows: row_diag[d, i] = A[i, i+o] = data[d, i+o].
        diags = np.zeros((len(offsets), n), dtype=np.dtype(jnp.dtype(dtype).name))
        for d, o in enumerate(offsets):
            if o >= 0:
                diags[d, : n - o] = a.data[d, o:n]
            else:
                diags[d, -o:n] = a.data[d, : n + o]
        return cls(diags=jnp.asarray(diags), offsets=offsets)

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        """(k, n) lanes-major apply: ``Yt[:, i] = sum_d c_d[i] * Xt[:, i+o_d]``.

        Toroidal semantics: col = (i + o) mod n. Constructors zero every
        coefficient without true wraparound coupling, so this equals the
        truncated apply for e.g. Laplacians."""
        from blockcg.solvers.common import acc_dtype

        k, n = Xt.shape
        adt = acc_dtype(Xt.dtype)  # bf16 inputs accumulate in f32
        Yt = jnp.zeros((k, n), dtype=adt)
        for d, o in enumerate(self.offsets):  # static unroll, ndiag is tiny
            c = self.diags[d][None, :].astype(adt)
            src = Xt if o == 0 else jnp.roll(Xt, -o, axis=1)
            Yt = Yt + c * src.astype(adt)
        return Yt.astype(Xt.dtype)


jax.tree_util.register_dataclass(
    DIAOperator,
    data_fields=["diags"],
    meta_fields=["offsets"],
)
