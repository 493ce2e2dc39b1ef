from blockcg.utils.metrics import (
    SolveRecord,
    convergence_history,
    log_jsonl,
    profile_trace,
    timed_solve,
)
from blockcg.utils.checkpoint import load_checkpoint, save_checkpoint
from blockcg.utils.io import load_operator, save_operator

__all__ = [
    "SolveRecord",
    "convergence_history",
    "log_jsonl",
    "profile_trace",
    "timed_solve",
    "load_checkpoint",
    "save_checkpoint",
    "load_operator",
    "save_operator",
]
