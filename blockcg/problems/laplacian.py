"""Laplacian problem generators (T-P1, north-star configs 1/2/3/5).

Reference equivalent: R10 test fixtures (SURVEY.md §3.1). Generators are
direct numpy constructions (no scipy.kron) so the 256^3 = 16.7M-row config
builds in seconds; scipy CSR export is provided for small test sizes.

Convention: d-dimensional 2d+1-point Laplacian with Dirichlet boundaries on a
grid of ``shape``; lexicographic (row-major, last axis fastest) ordering.
Diagonal = 2d, neighbors = -1. SPD with eigenvalues in (0, 4d).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from blockcg.operators import CSROperator, DIAOperator, ELLOperator


def _laplacian_bands(shape: tuple[int, ...], np_dtype) -> tuple[tuple[int, ...], np.ndarray]:
    """Row-aligned diagonals for the Dirichlet Laplacian on ``shape``.

    Returns (offsets, diags) with diags[d, i] multiplying X[i + offsets[d]].
    """
    ndim = len(shape)
    n = math.prod(shape)
    # Strides of each axis in lexicographic order (last axis fastest).
    strides = [math.prod(shape[ax + 1 :]) for ax in range(ndim)]
    offsets: list[int] = []
    diags: list[np.ndarray] = []

    idx = np.arange(n)
    coords = [(idx // strides[ax]) % shape[ax] for ax in range(ndim)]

    # Negative offsets first, then 0, then positive — sorted for DIA sanity.
    for ax in range(ndim):
        d = np.full(n, -1.0, dtype=np_dtype)
        d[coords[ax] == 0] = 0.0  # no neighbor below the boundary
        offsets.append(-strides[ax])
        diags.append(d)
    offsets.append(0)
    diags.append(np.full(n, 2.0 * ndim, dtype=np_dtype))
    for ax in range(ndim):
        d = np.full(n, -1.0, dtype=np_dtype)
        d[coords[ax] == shape[ax] - 1] = 0.0  # no neighbor above the boundary
        offsets.append(strides[ax])
        diags.append(d)

    order = np.argsort(offsets)
    offsets = [offsets[i] for i in order]
    diags = [diags[i] for i in order]
    return tuple(offsets), np.stack(diags)


def laplacian_dia(shape: tuple[int, ...], dtype=jnp.float32) -> DIAOperator:
    """Dirichlet Laplacian as a DIAOperator (the stencil fast path)."""
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    offsets, diags = _laplacian_bands(tuple(shape), np_dtype)
    return DIAOperator(diags=jnp.asarray(diags), offsets=offsets)


def laplacian_ell(shape: tuple[int, ...], dtype=jnp.float32) -> ELLOperator:
    """Dirichlet Laplacian as an ELLOperator (width = 2*ndim + 1)."""
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    offsets, diags = _laplacian_bands(tuple(shape), np_dtype)
    n = diags.shape[1]
    w = len(offsets)
    vals = np.ascontiguousarray(diags.T)  # (n, w)
    idx = np.arange(n)
    cols = np.empty((n, w), dtype=np.int32)
    for j, o in enumerate(offsets):
        # Out-of-range / boundary-zeroed slots keep a clipped (valid) index;
        # their value is exactly 0 so the gather is numerically inert.
        cols[:, j] = np.clip(idx + o, 0, n - 1)
    op = ELLOperator(vals=jnp.asarray(vals), cols=jnp.asarray(cols))
    object.__setattr__(op, "_nnz", int(np.count_nonzero(vals)))
    return op


def laplacian_scipy(shape: tuple[int, ...]):
    """scipy CSR export, for test comparisons (small shapes only)."""
    import scipy.sparse as sp

    offsets, diags = _laplacian_bands(tuple(shape), np.float64)
    n = diags.shape[1]
    # scipy.diags wants column-aligned diagonal arrays of length n - |o|:
    # our row-aligned diags[d, i] multiplies X[i+o], i.e. entry A[i, i+o].
    arrs = []
    for d, o in enumerate(offsets):
        if o >= 0:
            arrs.append(diags[d, : n - o])
        else:
            arrs.append(diags[d, -o:])
    return sp.diags(arrs, offsets, shape=(n, n), format="csr")


def laplacian_csr(shape: tuple[int, ...], dtype=jnp.float32) -> CSROperator:
    return CSROperator.from_scipy(laplacian_scipy(shape), dtype=dtype)
