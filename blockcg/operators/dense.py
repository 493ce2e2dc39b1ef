"""Dense operator — testing / small-problem path (reference R10 fixtures use
small random SPD matrices; SURVEY.md §5.1)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class DenseOperator(MatmatMixin):
    A: jax.Array

    @property
    def shape(self) -> tuple[int, int]:
        return self.A.shape

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def nnz(self) -> int:
        return self.A.shape[0] * self.A.shape[1]

    @property
    def dtype(self):
        return self.A.dtype

    def matmat(self, X: jax.Array) -> jax.Array:
        return jnp.matmul(
            self.A, X, precision=jax.lax.Precision.HIGHEST
        ).astype(X.dtype)

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        return jnp.matmul(
            Xt, self.A.T, precision=jax.lax.Precision.HIGHEST
        ).astype(Xt.dtype)


jax.tree_util.register_dataclass(DenseOperator, data_fields=["A"], meta_fields=[])
