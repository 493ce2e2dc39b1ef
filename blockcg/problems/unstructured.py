"""Unstructured (scattered-sparsity) SPD test problems.

Reference equivalent: R1 (SURVEY.md §3.1) — the reference's Eigen SpMM
accepts *arbitrary* CSR sparsity; these generators produce genuinely
unstructured SPD matrices (no stencil/lattice structure for the structured
formats to exploit) to exercise the T-K1 general path:

- ``delaunay_laplacian``: graph Laplacian (+I) of a Delaunay triangulation
  of random points — the classic 2D unstructured-mesh (FEM-like) sparsity,
  average degree ~7.
- ``rgg_laplacian``: random geometric graph Laplacian (+I) with a target
  average degree — degree is the knob for the tile-density -> throughput
  curve (the tile format's efficiency scales with tile fill).

Both return scipy CSR in f64; cast/convert at the call site
(TiledOperator.from_scipy / CSROperator.from_scipy).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _graph_laplacian(n: int, edges: np.ndarray) -> sp.csr_matrix:
    """SPD graph Laplacian + I from an (m, 2) undirected edge list."""
    if len(edges) == 0:
        return sp.eye(n, format="csr")
    A = sp.coo_matrix(
        (np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n)
    )
    A = (A + A.T).tocsr()
    A.data[:] = 1.0  # dedupe parallel edges
    deg = np.asarray(A.sum(axis=1)).ravel()
    return (sp.diags(deg + 1.0) - A).tocsr()


def delaunay_points(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n, 2))


def delaunay_laplacian(n: int, seed: int = 0) -> sp.csr_matrix:
    """Graph Laplacian (+I) of the Delaunay triangulation of n random
    points in the unit square. SPD, avg degree ~7, planar — RCM reordering
    recovers an O(sqrt(n)) band from the scattered natural order."""
    from scipy.spatial import Delaunay

    tri = Delaunay(delaunay_points(n, seed))
    s = tri.simplices
    edges = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    edges = np.unique(edges, axis=0)
    return _graph_laplacian(n, edges)


def rgg_laplacian(n: int, degree: float = 20.0, seed: int = 0) -> sp.csr_matrix:
    """Random geometric graph Laplacian (+I): n uniform points in the unit
    square, edges within radius r chosen for the target average degree
    (``degree ~= pi r^2 n``). Unstructured but locality-rich — the honest
    middle ground between lattice stencils and uniform random sparsity."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    r = float(np.sqrt(degree / (np.pi * n)))
    pairs = cKDTree(pts).query_pairs(r, output_type="ndarray")
    return _graph_laplacian(n, pairs)


def uniform_random_spd(n: int, degree: float = 8.0, seed: int = 0) -> sp.csr_matrix:
    """Uniformly scattered symmetric sparsity (no locality at all) made SPD
    by diagonal dominance — the worst case for any tiling: RCM cannot
    densify an expander. Anchors the low end of the density curve."""
    rng = np.random.default_rng(seed)
    m = int(n * degree / 2)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    keep = rows != cols
    edges = np.sort(np.stack([rows[keep], cols[keep]], axis=1), axis=1)
    edges = np.unique(edges, axis=0)
    return _graph_laplacian(n, edges)


def random_regular_spd(n: int, degree: int = 8, seed: int = 0) -> sp.csr_matrix:
    """Exact d-regular expander-like graph (union of ``degree`` random
    perfect matchings via permutation symmetrization), made SPD as L + I.

    The no-locality bound case: every row has exactly ``degree``
    off-diagonal entries with uniformly random targets, so NO reordering
    can densify tiles — the SpMM's speed of light is the device's random
    row-gather bandwidth (bench_scattered.py measures it)."""
    if degree % 2:
        raise ValueError("degree must be even (union of 2-regular "
                         "permutation cycles)")
    rng = np.random.default_rng(seed)
    edges = []
    # Each random permutation's functional graph is 2-regular (every vertex
    # is one edge's source and one edge's target), so degree/2 permutations
    # give an exactly degree-regular multigraph up to the rare self-loop/
    # duplicate collision.
    for _ in range(degree // 2):
        p = rng.permutation(n)
        e = np.stack([np.arange(n), p], axis=1)
        e = e[e[:, 0] != e[:, 1]]
        edges.append(np.sort(e, axis=1))
    edges = np.unique(np.concatenate(edges, axis=0), axis=0)
    return _graph_laplacian(n, edges)
