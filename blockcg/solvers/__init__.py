from blockcg.solvers.cg import solve_cg
from blockcg.solvers.bcg import solve_bcg
from blockcg.solvers.bcga import solve_bcga
from blockcg.solvers.bcgdq import solve_bcgdq
from blockcg.solvers.sbcgrq import solve_sbcgrq
from blockcg.solvers.deflate import solve_sbcgrq_deflated

# Dubrulle-ladder naming parity (BIT 41 (2001)): the reference README's
# "BCGrQ" is the residual-QR member of the ladder — our SBCGrQ.
solve_bcgrq = solve_sbcgrq
from blockcg.solvers.pbcg import (jacobi_preconditioner,
                                      solve_pbcg, solve_psbcgrq)
from blockcg.solvers.poly import solve_sbcgrq_cheb
from blockcg.solvers.refine import solve_refined, solve_refined_lean
from blockcg.solvers.shifted import solve_shifted_cg
from blockcg.solvers.shifted_block import solve_shifted_sbcgrq
from blockcg.solvers.common import cholqr, block_dot, col_norms2

__all__ = [
    "solve_cg",
    "solve_bcg",
    "solve_bcga",
    "solve_bcgdq",
    "solve_pbcg",
    "solve_psbcgrq",
    "jacobi_preconditioner",
    "solve_bcgrq",
    "solve_sbcgrq",
    "solve_sbcgrq_deflated",
    "solve_refined",
    "solve_refined_lean",
    "solve_sbcgrq_cheb",
    "solve_shifted_cg",
    "solve_shifted_sbcgrq",
    "cholqr",
    "block_dot",
    "col_norms2",
]
