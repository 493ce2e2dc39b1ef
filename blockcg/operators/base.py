"""LinearOperator protocol (L2 public interface, SURVEY.md §2.2).

The reference applies ``A`` through Eigen sparse-times-dense products
(SURVEY.md R1). Here every operator is a *pytree dataclass* so it can be
passed straight through ``jax.jit`` / ``shard_map``: array leaves are traced,
structural metadata (shape, format parameters) is static.

Two apply entry points:

- ``matmat(X) -> A @ X`` for an (n, k) block — the public convention
  (matches the reference's column-block layout).
- ``matmat_t(Xt) -> (A @ X)^T`` for a (k, n) *lanes-major* block — the hot
  internal convention: the row dimension n is the contiguous minor axis, so
  every field pass streams whole rows of k-wide blocks; solvers keep all
  their block state in this layout (SURVEY.md L1/L2 boundary).

Operators natively implement whichever direction is natural and get the
other via the transpose fallbacks below; the performance-critical formats
(DIA/BSR) implement ``matmat_t`` natively.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import jax


@runtime_checkable
class LinearOperator(Protocol):
    """Anything that can apply ``A @ X`` to a dense block."""

    @property
    def shape(self) -> tuple[int, int]: ...

    @property
    def nnz(self) -> int: ...

    def matmat(self, X: jax.Array) -> jax.Array: ...

    def matmat_t(self, Xt: jax.Array) -> jax.Array: ...

    def __call__(self, X: jax.Array) -> jax.Array: ...


class MatmatMixin:
    """Fallback glue: ``op(X)``, and each of matmat/matmat_t in terms of the
    other (subclasses must define at least one natively)."""

    def __call__(self, X):
        return self.matmat(X)

    def matmat(self, X):
        squeeze = X.ndim == 1
        Xt = X[None, :] if squeeze else X.T
        Yt = self.matmat_t(Xt)
        return Yt[0] if squeeze else Yt.T

    def matmat_t(self, Xt):
        return self.matmat(Xt.T).T

    def matvec(self, x):
        """(n,) -> (n,) single-vector apply via the lanes-major path."""
        return self.matmat_t(x[None, :])[0]

    def matmat_gram_t(self, Xt):
        """(Y = A X, G) where G = X^H Y, contracted to k x k and local to
        this shard (the caller psums). Solvers use this for the P^H(AP)
        Gram; an operator with a fused apply-plus-Gram overrides it."""
        from blockcg.solvers.common import gram_t

        Yt = self.matmat_t(Xt)
        return Yt, gram_t(Xt, Yt, codec=self)

    # Internal field layout hooks. Solvers carry their lanes-major block
    # state in whatever view the operator's apply wants — for block-spin
    # operators the merged spin-major (m = bs*k, ns) view. Converting between
    # layouts is a physical relayout copy of the whole block, so it happens
    # once at solve entry/exit and the hot loop is relayout-free. Default:
    # flat (k, n) is already internal.

    def to_internal(self, Xt):
        """Lanes-major (k, n) -> the operator's internal field view."""
        return Xt

    def from_internal(self, Xf):
        """Internal field view -> lanes-major (k, n)."""
        return Xf

    # Field-algebra codec. Operators whose internal field merges extra row
    # structure into the leading dim (e.g. the const-hop block operator's
    # merged spin-major (m = bs*k, ns) layout) override these so
    # the solvers' coefficient algebra stays k x k:
    #   - a k x k coefficient C applied to a field expands to the internal
    #     row dim (I_bs (x) C for spin-major merging),
    #   - an internal-rows Gram / squared-norm vector contracts back to
    #     k x k / (k,) (sum of diagonal spin blocks).
    # Defaults: identity (flat (k, n) fields).

    # API-boundary row-order hooks. Operators that apply in a PERMUTED row
    # order (e.g. the RCM-reordered tile operator) override these; the
    # identity defaults let generic user code be written once for every
    # format:  X = op.from_solver_order(solve(op, op.to_solver_order(B))).

    def to_solver_order(self, B):
        """(n, k) RHS in the original row order -> the operator's order."""
        return B

    def from_solver_order(self, X):
        """Inverse of :meth:`to_solver_order`."""
        return X

    def coeff_expand(self, C):
        return C

    def gram_contract(self, G):
        return G

    def norms2_contract(self, v):
        return v


def astype(op, dtype):
    """Cast an operator pytree's float arrays to ``dtype`` (indices kept).

    Complex leaves are promoted to the matching complex width (f64 ->
    complex128), so the refinement driver's true-residual operator really
    is wide for Hermitian systems. Used by solve_refined to get an f64/
    c128 operator from the f32/c64 compute operator.

    Operators whose width lives in STRUCTURAL metadata (not array leaves —
    e.g. the realified wrapper's cdtype) override ``astype_op``; the plain
    tree_map below cannot change those.
    """
    import jax.numpy as jnp

    hook = getattr(op, "astype_op", None)
    if hook is not None:
        return hook(dtype)

    dtype = jnp.dtype(dtype)
    cdtype = jnp.complex128 if dtype.itemsize == 8 else jnp.complex64

    def cast(x):
        if not hasattr(x, "dtype"):
            return x
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            return x.astype(
                dtype if jnp.issubdtype(dtype, jnp.complexfloating) else cdtype
            )
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(
                jnp.float64 if jnp.issubdtype(dtype, jnp.complexfloating)
                and dtype.itemsize == 16 else dtype
            )
        return x

    return jax.tree.map(cast, op)
