"""Observability (T-O1, SURVEY.md §6).

The reference prints iteration counts and final residuals; here solves emit
structured per-run records (JSON-lines) with throughput figures, plus hooks
into ``jax.profiler`` for TensorBoard/Perfetto traces.

Timing: JAX dispatch is asynchronous, so ``timed()`` below forces a value
fetch; for microbenchmarks use differenced chained loops as in bench.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any

import jax
import jax.numpy as jnp

from blockcg.types import SolverInfo


@dataclasses.dataclass
class SolveRecord:
    """One solve, fully described — the unit of the structured log."""

    solver: str
    n: int
    k: int
    nnz: int
    tol: float
    iterations: int
    matvecs: int
    converged: bool
    max_relres: float
    wall_s: float
    nnz_per_s: float
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return json.dumps(d)


def timed_solve(
    solver_name: str, solve_fn, op, B, *, tol: float, warm: bool = True,
    **kwargs
) -> tuple[Any, SolverInfo, SolveRecord]:
    """Run a solve, force completion, and build a SolveRecord.

    ``solve_fn(op, B, tol=..., **kwargs) -> (X, info)``. With ``warm`` the
    solve runs twice and the SECOND run is timed — the first pays jit
    compilation, which would otherwise dominate ``wall_s``; the compile time
    is recorded separately in ``extra['compile_wall_s']``.
    """
    compile_wall = None
    if warm:
        t0 = time.time()
        Xw, infow = solve_fn(op, B, tol=tol, **kwargs)
        _ = int(infow.iterations)
        compile_wall = time.time() - t0
    t0 = time.time()
    X, info = solve_fn(op, B, tol=tol, **kwargs)
    iters = int(info.iterations)  # value fetch forces execution
    wall = time.time() - t0
    mv = int(info.matvecs)
    k = 1 if B.ndim == 1 else B.shape[-1]
    rec = SolveRecord(
        solver=solver_name,
        n=op.shape[0],
        k=k,
        nnz=op.nnz,
        tol=float(tol),
        iterations=iters,
        matvecs=mv,
        converged=bool(jnp.all(info.converged)),
        max_relres=float(jnp.max(info.relres)),
        wall_s=wall,
        nnz_per_s=op.nnz * mv / wall if wall > 0 else float("nan"),
    )
    if compile_wall is not None:
        rec.extra["compile_wall_s"] = round(compile_wall, 3)
    return X, info, rec


def log_jsonl(path: str, record: SolveRecord | dict) -> None:
    line = record.to_json() if isinstance(record, SolveRecord) else json.dumps(record)
    with open(path, "a") as f:
        f.write(line + "\n")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace around a solve (view in TensorBoard/Perfetto)."""
    with jax.profiler.trace(logdir):
        yield


def convergence_history(info: SolverInfo):
    """Trimmed per-iteration max-relative-residual trace (needs a solve run
    with ``record_history=True``)."""
    import numpy as np

    if info.history is None:
        raise ValueError("solve was not run with record_history=True")
    h = np.asarray(info.history)
    return h[: int(info.iterations)]
