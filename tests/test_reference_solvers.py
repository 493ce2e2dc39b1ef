"""f64 oracle solvers: correctness vs direct solves + the §1.2 invariant.

This reproduces the reference's own test strategy (SURVEY.md §5.1): small
SPD matrices, random RHS, assert residual <= tol and agreement with a direct
solve; plus the SBCGrQ self-consistency invariant ``B - A X = Q S``.
"""

import numpy as np

from blockcg.problems import random_spd, random_block, laplacian_scipy
from blockcg.solvers.reference import ref_cg, ref_bcg, ref_sbcgrq


def test_ref_cg_matches_direct():
    A = random_spd(120, seed=0)
    b = random_block(120, 1, seed=1)[:, 0]
    x, it = ref_cg(A, b, tol=1e-12)
    assert np.linalg.norm(A @ x - b) <= 1e-11 * np.linalg.norm(b)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-8, atol=1e-10)
    assert 0 < it < 400


def test_ref_bcg_matches_direct():
    A = random_spd(150, seed=2)
    B = random_block(150, 6, seed=3)
    X, it = ref_bcg(A, B, tol=1e-11)
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10
    assert it < 150


def test_ref_sbcgrq_invariant_and_convergence():
    """SURVEY.md §1.2 validation: converges faster than per-RHS CG and the
    invariant drift ||(B-AX) - QS||/||B|| stays at machine epsilon."""
    A = random_spd(300, seed=4)
    B = random_block(300, 8, seed=5)
    X, it, drift = ref_sbcgrq(A, B, tol=1e-12, return_invariant=True)
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-11
    assert drift < 1e-12

    # block solver uses fewer iterations than the worst single-RHS CG
    _, it_cg = ref_cg(A, B[:, 0], tol=1e-12)
    assert it <= it_cg


def test_ref_solvers_on_laplacian():
    a = laplacian_scipy((12, 12))
    n = a.shape[0]
    B = random_block(n, 4, seed=6)
    X, _ = ref_sbcgrq(a, B, tol=1e-12)
    res = np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-11
