"""Named problem presets — the five north-star configs (BASELINE.json).

Each preset returns ``(op, B, meta)`` where ``op`` is the recommended operator
format for that config, ``B`` a deterministic random RHS block, and ``meta``
a dict with solver/config details for the bench CLI (T-B1).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from blockcg.problems.laplacian import laplacian_dia, laplacian_ell
from blockcg.problems.dirac import dirac_cbdia


def _rhs(n: int, k: int, dtype, seed: int = 42):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, k))
    return jnp.asarray(b, dtype=dtype)


def config1_cg_2d_128(dtype=jnp.float32):
    """2D 5-pt Laplacian 128x128 (16k rows), 4 RHS, plain CG."""
    op = laplacian_dia((128, 128), dtype=dtype)
    return op, _rhs(op.n, 4, dtype), {"solver": "cg", "name": "cg_2d_128"}


def config2_bcg_2d_512(dtype=jnp.float32):
    """2D Laplacian 512x512, 16 RHS, BCG (vs per-RHS CG comparison)."""
    op = laplacian_dia((512, 512), dtype=dtype)
    return op, _rhs(op.n, 16, dtype), {"solver": "bcg", "name": "bcg_2d_512"}


def config3_sbcgrq_3d_64(dtype=jnp.float32, shape=(64, 64, 64)):
    """3D 7-pt Laplacian 64^3 (262k rows), 32 RHS, SBCGrQ."""
    op = laplacian_dia(shape, dtype=dtype)
    return op, _rhs(op.n, 32, dtype), {"solver": "sbcgrq", "name": "sbcgrq_3d_64"}


def config4_dirac_32(dtype=jnp.float32, L: int = 32):
    """4x4-block lattice-Dirac-like SPD operator on L^4 (default 32^4), 12 RHS.

    Uses the ConstBlockDIA container (compile-time constant hops); the
    same matrix is also constructible as general BlockDIA (dirac_bdia) or
    generic BSR (dirac_bell).
    """
    op = dirac_cbdia(L, m=0.5, dtype=dtype)
    return op, _rhs(op.n, 12, dtype), {"solver": "sbcgrq", "name": f"dirac_{L}"}


def config5_sbcgrq_3d_256(dtype=jnp.float32, shape=(256, 256, 256)):
    """3D Laplacian 256^3 (16.7M rows), 64 RHS, SBCGrQ, row-partitioned."""
    op = laplacian_dia(shape, dtype=dtype)
    return op, _rhs(op.n, 64, dtype), {"solver": "sbcgrq", "name": "sbcgrq_3d_256"}


PRESETS = {
    "cg_2d_128": config1_cg_2d_128,
    "bcg_2d_512": config2_bcg_2d_512,
    "sbcgrq_3d_64": config3_sbcgrq_3d_64,
    "dirac_32": config4_dirac_32,
    "sbcgrq_3d_256": config5_sbcgrq_3d_256,
}
