from blockcg.problems.laplacian import (
    laplacian_csr,
    laplacian_dia,
    laplacian_ell,
    laplacian_scipy,
)
from blockcg.problems.dirac import (
    bdia_scipy,
    dirac_bdia,
    dirac_cbdia,
    dirac_bell,
    dirac_gauged,
    dirac_gauged_matrix,
    dirac_gauged_cbdia,
    dirac_scipy,
)
from blockcg.problems.dirac_eo import (
    EOContext,
    dirac_eo,
    dirac_gauged_eo,
    dirac_gauged_matrix_eo,
    eo_assemble,
    eo_split,
    solve_dirac_eo,
    solve_dirac_eo_dist,
    solve_dirac_eo_shifted,
)
from blockcg.problems.random_spd import random_spd, random_block
from blockcg.problems.unstructured import (
    delaunay_laplacian,
    rgg_laplacian,
    random_regular_spd,
    uniform_random_spd,
)
from blockcg.problems.presets import PRESETS

__all__ = [
    "laplacian_csr",
    "laplacian_dia",
    "laplacian_ell",
    "laplacian_scipy",
    "bdia_scipy",
    "dirac_bdia",
    "dirac_cbdia",
    "dirac_bell",
    "dirac_gauged",
    "dirac_gauged_matrix",
    "dirac_gauged_cbdia",
    "dirac_scipy",
    "EOContext",
    "dirac_eo",
    "dirac_gauged_eo",
    "dirac_gauged_matrix_eo",
    "eo_assemble",
    "eo_split",
    "solve_dirac_eo",
    "solve_dirac_eo_dist",
    "solve_dirac_eo_shifted",
    "random_spd",
    "random_block",
    "delaunay_laplacian",
    "rgg_laplacian",
    "random_regular_spd",
    "uniform_random_spd",
    "PRESETS",
]
