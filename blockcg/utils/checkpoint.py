"""Checkpoint / resume (SURVEY.md §6).

The reference has none; the minimal story here: CG-family restarts are
mathematically clean at residual-replacement boundaries, so checkpointing
the solution block there (plus problem metadata) makes any solve resumable —
resume = warm-start from the checkpointed X (all solvers accept ``X0``).
``solve_refined`` checkpoints between refinement cycles when given a path.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp


def save_checkpoint(path: str, X, *, iteration: int = 0, meta: dict | None = None):
    """Atomic save of the current solution block (+ small metadata)."""
    tmp = path + ".tmp"
    arrs = {"X": np.asarray(X), "iteration": np.asarray(iteration)}
    if meta:
        for k, v in meta.items():
            arrs[f"meta_{k}"] = np.asarray(v)
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns (X, iteration, meta) or None when no checkpoint exists."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        X = jnp.asarray(z["X"])
        it = int(z["iteration"])
        meta = {
            k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")
        }
    return X, it, meta
