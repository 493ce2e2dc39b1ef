"""blockcg: block conjugate-gradient solvers in JAX.

A JAX/XLA framework providing the solver capabilities of the reference
``lkeegan/blockCG`` (C++/Eigen, single process): CG, block CG (BCG,
O'Leary 1980), and the thin-QR-stabilized SBCGrQ variant (Dubrulle, BIT 41
(2001)) for symmetric positive-definite sparse systems ``A X = B`` with many
right-hand sides.

Parity is against the capability contract in SURVEY.md / BASELINE.json
(solver family + recurrences in SURVEY.md §1.2, component inventory §3).

Layering (SURVEY.md §2.2):
  L4 solver API    : solve_cg / solve_bcg / solve_sbcgrq  (this module's exports)
  L3 solver core   : jitted ``lax.while_loop`` bodies (blockcg.solvers)
  L2 dist. algebra : row-partitioned operator, halo exchange, psum Gram
                     (blockcg.parallel)
  L1 operators     : SpMM formats (blockcg.operators), compiled by XLA
  L0 platform      : jax, shard_map, a 1-D device mesh
"""

from blockcg.utils.platform import enable_compilation_cache as _encc

# Persistent compilation cache, enabled for every entry point by the
# package import itself (pure config: touches no backend). The cache key
# hashes the serialized HLO, so code edits never hit stale entries.
_encc()

from blockcg.types import SolverOptions, SolverInfo
from blockcg.operators import (
    CSROperator,
    ELLOperator,
    DIAOperator,
    BSROperator,
    DenseOperator,
)
from blockcg.solvers import (
    solve_cg,
    solve_bcg,
    solve_bcga,
    solve_bcgdq,
    solve_pbcg,
    solve_psbcgrq,
    jacobi_preconditioner,
    solve_bcgrq,
    solve_sbcgrq,
    solve_sbcgrq_deflated,
    solve_refined,
    solve_refined_lean,
    solve_sbcgrq_cheb,
    solve_shifted_cg,
    solve_shifted_sbcgrq,
)

__version__ = "0.1.0"

__all__ = [
    "SolverOptions",
    "SolverInfo",
    "CSROperator",
    "ELLOperator",
    "DIAOperator",
    "BSROperator",
    "DenseOperator",
    "solve_cg",
    "solve_bcg",
    "solve_bcga",
    "solve_bcgdq",
    "solve_bcgrq",
    "solve_sbcgrq",
    "solve_sbcgrq_deflated",
    "solve_refined",
    "solve_refined_lean",
    "solve_sbcgrq_cheb",
    "solve_shifted_cg",
    "solve_shifted_sbcgrq",
]
