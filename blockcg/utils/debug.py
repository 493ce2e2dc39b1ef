"""NaN/Inf tripwires for solver debugging (SURVEY.md §6 race-detection
analog: the pure-functional SPMD model has no data races — the failure
modes are numerical, and silent NaNs inside a jitted while_loop surface
only as a non-converging solve).

``checked_operator`` wraps any LinearOperator so every apply asserts its
output is finite, reporting through ``jax.experimental.checkify`` — works
inside jit/while_loop and on every backend.

    from blockcg.utils.debug import checked_operator, run_checked
    op_dbg = checked_operator(op)
    err, (X, info) = run_checked(lambda: bc.solve_sbcgrq(op_dbg, B))
    err.throw()   # raises with the tripwire message if any apply went bad
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from blockcg.operators.base import MatmatMixin


@dataclasses.dataclass
class CheckedOperator(MatmatMixin):
    """Wraps ``base``: every ``matmat_t`` output is checked finite."""

    base: object

    @property
    def shape(self):
        return self.base.shape

    @property
    def n(self):
        return self.base.shape[0]

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def dtype(self):
        return self.base.dtype

    def to_internal(self, Xt):
        return self.base.to_internal(Xt)

    def from_internal(self, Xv):
        return self.base.from_internal(Xv)

    def matmat_t(self, Xt):
        Yt = self.base.matmat_t(Xt)
        checkify.check(
            jnp.all(jnp.isfinite(jnp.real(Yt)) & jnp.isfinite(jnp.imag(Yt)))
            if jnp.issubdtype(Yt.dtype, jnp.complexfloating)
            else jnp.all(jnp.isfinite(Yt)),
            "operator apply produced non-finite values",
        )
        return Yt


jax.tree_util.register_dataclass(
    CheckedOperator, data_fields=["base"], meta_fields=[]
)


def checked_operator(op) -> CheckedOperator:
    return CheckedOperator(base=op)


def run_checked(thunk):
    """Run ``thunk()`` under checkify, functionalizing the tripwires.

    Returns (err, result); call ``err.throw()`` to surface failures."""
    return checkify.checkify(thunk)()
