"""Ring halo exchange (T-D1, SURVEY.md §3.4).

The reference is single-process (no comms); the distribution story here is:
matrix rows sharded over a 1-D mesh axis, boundary columns of the RHS block
exchanged with ring neighbors via ``lax.ppermute`` (collectives XLA hands to
the interconnect), k x k reductions via ``psum`` (solvers/common.py).

The ring is toroidal, which matches the operators' toroidal stencil
semantics exactly: the wraparound halo of shard 0 comes from shard D-1, and
operators without global wrap coupling have zero coefficients there.
"""

from __future__ import annotations

import jax
from jax import lax


def ring_halos(Xl: jax.Array, bw: int, axis_name: str):
    """Exchange boundary slices of the minor (row) axis with ring neighbors.

    Args:
      Xl: local shard, row axis last, shape (..., nl).
      bw: halo width (rows), bw <= nl.
      axis_name: mesh axis the rows are sharded over.

    Returns:
      (halo_l, halo_r): left neighbor's last ``bw`` rows and right neighbor's
      first ``bw`` rows, each shaped (..., bw).
    """
    D = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % D) for i in range(D)]  # send to right neighbor
    bwd = [(i, (i - 1) % D) for i in range(D)]  # send to left neighbor
    halo_l = lax.ppermute(Xl[..., -bw:], axis_name, fwd)
    halo_r = lax.ppermute(Xl[..., :bw], axis_name, bwd)
    return halo_l, halo_r
