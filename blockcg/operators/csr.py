"""CSR and ELL sparse operators with XLA apply paths.

Reference equivalent: R1 in SURVEY.md §3.1 (Eigen sparse * dense). These
containers hold the matrix in device arrays; ``matmat`` here is the pure-XLA
path (gather + segment-sum / gather + fma), also the correctness baseline
for the structured formats.

ELL is the static-shape regularization of CSR: rows are padded to a fixed
width ``w`` so every shape is static. Padded slots point at the row's own
index with value 0 (a safe, local gather).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class CSROperator(MatmatMixin):
    """CSR stored as COO-ish triplets for XLA segment-sum apply.

    vals: (nnz,) float; cols: (nnz,) int32; row_ids: (nnz,) int32 sorted.
    """

    vals: jax.Array
    cols: jax.Array
    row_ids: jax.Array
    n: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, a, dtype=jnp.float32) -> "CSROperator":
        a = a.tocsr()
        n = a.shape[0]
        row_ids = np.repeat(np.arange(n, dtype=np.int32), np.diff(a.indptr))
        return cls(
            vals=jnp.asarray(a.data, dtype=dtype),
            cols=jnp.asarray(a.indices, dtype=jnp.int32),
            row_ids=jnp.asarray(row_ids),
            n=int(n),
        )

    def matmat(self, X: jax.Array) -> jax.Array:
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        gathered = self.vals[:, None] * X[self.cols]  # (nnz, k)
        Y = jax.ops.segment_sum(
            gathered, self.row_ids, num_segments=self.n, indices_are_sorted=True
        )
        return Y[:, 0] if squeeze else Y


jax.tree_util.register_dataclass(
    CSROperator,
    data_fields=["vals", "cols", "row_ids"],
    meta_fields=["n"],
)


@dataclasses.dataclass
class ELLOperator(MatmatMixin):
    """ELLPACK: fixed-width rows. vals/cols: (n, w). Static shapes throughout.

    The apply loops over the width dimension (w is small: 5 for 2D Laplacian,
    7 for 3D), doing one (n, k) row-gather + fused multiply-add per diagonal
    slot — this keeps the intermediate at (n, k) instead of (n, w, k).
    """

    vals: jax.Array
    cols: jax.Array

    @property
    def shape(self) -> tuple[int, int]:
        n = self.vals.shape[0]
        return (n, n)

    @property
    def n(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def nnz(self) -> int:
        # Logical nnz: padded slots hold value exactly 0 (the documented
        # construction convention), so a hand-built ELL is counted by its
        # nonzeros — ONE device->host fetch, cached; touch ``nnz`` before a
        # timed region (from_scipy pre-sets the count, so only hand-built
        # operators pay it). Under tracing (no concrete values) fall back
        # to the padded upper bound rather than crash.
        cached = getattr(self, "_nnz", None)
        if cached is None:
            try:
                cached = int(np.count_nonzero(np.asarray(self.vals)))
            except jax.errors.TracerArrayConversionError:
                return self.vals.shape[0] * self.vals.shape[1]
            object.__setattr__(self, "_nnz", cached)
        return cached

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, a, dtype=jnp.float32, width: int | None = None) -> "ELLOperator":
        a = a.tocsr()
        n = a.shape[0]
        counts = np.diff(a.indptr)
        w = int(counts.max()) if width is None else int(width)
        if w < counts.max():
            raise ValueError(f"width {w} < max row nnz {counts.max()}")
        vals = np.zeros((n, w), dtype=np.dtype(jnp.dtype(dtype).name))
        # Padded columns point at the row itself: the gather stays local and
        # multiplies by zero, so padding is numerically inert.
        cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
        # Vectorized scatter (CSR data is row-major, so a row-mask assign
        # consumes it in order): the per-row Python loop was O(n) host time
        # — seconds at production row counts.
        mask = np.arange(w)[None, :] < counts[:, None]
        vals[mask] = a.data
        cols[mask] = a.indices
        op = cls(vals=jnp.asarray(vals), cols=jnp.asarray(cols))
        object.__setattr__(op, "_nnz", int(counts.sum()))
        return op

    def matmat(self, X: jax.Array) -> jax.Array:
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        Y = jnp.zeros((self.n, X.shape[1]), dtype=X.dtype)
        for j in range(self.width):  # w is tiny and static: unrolled under jit
            Y = Y + self.vals[:, j : j + 1] * X[self.cols[:, j]]
        return Y[:, 0] if squeeze else Y


jax.tree_util.register_dataclass(
    ELLOperator,
    data_fields=["vals", "cols"],
    meta_fields=[],
)
