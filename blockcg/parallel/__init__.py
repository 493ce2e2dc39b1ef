"""L2: distributed linear algebra — row partitioning, halo exchange, psum
Gram reductions (SURVEY.md T-D1/T-D2)."""

from blockcg.parallel.halo import ring_halos
from blockcg.parallel.dist_ops import (
    DistDIAOperator,
    DistBlockDIAOperator,
    DistConstBlockDIAOperator,
    partition_dia,
    partition_bdia,
    partition_cbdia,
    to_dist_order,
    from_dist_order,
)
from blockcg.parallel.api import (
    row_mesh,
    solve_cg_dist,
    solve_bcg_dist,
    solve_sbcgrq_dist,
    solve_sbcgrq_deflated_dist,
    solve_refined_dist,
    solve_sbcgrq_cheb_dist,
    solve_psbcgrq_dist,
    solve_shifted_sbcgrq_dist,
)
from blockcg.parallel.dist_ops import (  # noqa: F401
    DistEONormalOperator,
    DistSchurEvenOperator,
    partition_dirac_eo,
)

__all__ = [
    "ring_halos",
    "DistDIAOperator",
    "DistBlockDIAOperator",
    "DistConstBlockDIAOperator",
    "partition_dia",
    "partition_bdia",
    "partition_cbdia",
    "to_dist_order",
    "from_dist_order",
    "row_mesh",
    "solve_cg_dist",
    "solve_bcg_dist",
    "solve_sbcgrq_dist",
    "solve_sbcgrq_deflated_dist",
    "solve_refined_dist",
    "solve_sbcgrq_cheb_dist",
    "solve_psbcgrq_dist",
    "solve_shifted_sbcgrq_dist",
    "DistEONormalOperator",
    "DistSchurEvenOperator",
    "partition_dirac_eo",
]
