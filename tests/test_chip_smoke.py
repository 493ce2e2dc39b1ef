"""f32 integration tests of paths chip_smoke.py also drives, plus tests of
chip_smoke.py itself at tiny sizes on the CPU.

The tiled general-sparsity apply and a 1-device mesh (the full shard_map
machinery: specs, psum/ppermute lowering, on one device) run here as on
the card. The phase functions of chip_smoke.py run at tiny sizes on the
CPU with the same checks they make on the card; the script itself must
refuse to run without a GPU.
"""

import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from blockcg import solve_sbcgrq
from blockcg.operators import TiledOperator
from blockcg.parallel import partition_dia, row_mesh, solve_sbcgrq_dist
from blockcg.problems import laplacian_dia, laplacian_scipy, random_block


def test_tiled_solve_f32():
    """General-sparsity (tiled-MXU) SpMM driving a full f32 solve."""
    a = laplacian_scipy((20, 20))  # n=400 -> padded to 512
    op = TiledOperator.from_scipy(a, dtype=jnp.float32)
    B = np.zeros((op.n, 4), np.float32)
    B[:400] = random_block(400, 4, seed=8)
    X, info = solve_sbcgrq(op, jnp.asarray(B), tol=1e-5, max_iter=400)
    assert bool(info.converged.all())
    res = np.linalg.norm(a @ np.asarray(X)[:400] - B[:400], axis=0)
    res /= np.linalg.norm(B[:400], axis=0)
    assert res.max() <= 5e-5


def test_shard_map_single_device_solve_f32():
    """Full distributed entry point on a 1-device mesh: compiles and solves
    on a single device (the ring ppermute maps to self; psums are no-ops).
    Compares against the plain single-device solver."""
    shape = (16, 16)
    op = laplacian_dia(shape, dtype=jnp.float32)
    B = jnp.asarray(random_block(op.n, 4, seed=9), jnp.float32)
    mesh = row_mesh(1)
    dop = partition_dia(op, 1)
    X_d, info_d = solve_sbcgrq_dist(dop, B, mesh, tol=1e-5, max_iter=400)
    assert bool(info_d.converged.all())
    a = laplacian_scipy(shape)
    res = np.linalg.norm(a @ np.asarray(X_d) - np.asarray(B), axis=0)
    res /= np.linalg.norm(np.asarray(B), axis=0)
    assert res.max() <= 5e-5
    X_s, info_s = solve_sbcgrq(op, B, tol=1e-5, max_iter=400)
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= 2


def test_rcm_bf16_tiled_solve_f32():
    """Scattered-sparsity fast path end-to-end in f32: RCM-reordered tile
    operator with bf16 tile storage (upcast to f32 at apply) driving a
    solve through the order-conversion helpers."""
    from blockcg.problems import delaunay_laplacian

    a = delaunay_laplacian(2000, seed=11)
    op = TiledOperator.from_scipy(a, dtype=jnp.float32, reorder="rcm",
                                  tile_dtype=jnp.bfloat16)
    B = random_block(2000, 8, seed=12).astype(np.float32)
    Bi = op.to_solver_order(jnp.asarray(B))
    X, info = solve_sbcgrq(op, Bi, tol=1e-4, max_iter=600)
    assert bool(info.converged.all())
    Xo = np.asarray(op.from_solver_order(X), np.float64)
    res = np.linalg.norm(a @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-3


# --------------------------------------------------- chip_smoke.py itself --

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the script exits non-zero, says so, prints no result."""
    r = _run_script(_ROOT)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails and prints no result."""
    shutil.copy(_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_phase_config3_tiny(capsys):
    cs = _load_chip_smoke()
    rec = cs.phase_config3("cpu-test", shape=(8, 8, 16))
    assert rec["true_relres"] <= 1e-5 and rec["iterations"] > 0
    assert capsys.readouterr().out.startswith("PHASE ")


def test_chip_smoke_phase_config4_tiny():
    cs = _load_chip_smoke()
    rec = cs.phase_config4("cpu-test", L=4)
    assert rec["apply_rel_err"] <= 1e-5 and rec["true_relres"] <= 1e-5


def test_chip_smoke_phase_northstar_tiny():
    cs = _load_chip_smoke()
    rec = cs.phase_northstar("cpu-test", shape=(12, 12, 12), k=8)
    assert rec["true_relres"] <= 1e-10


def test_chip_smoke_phase_config5_tiny():
    cs = _load_chip_smoke()
    rec = cs.phase_config5("cpu-test", shape=(16, 16, 16))
    assert rec["k"] == 64 and rec["true_relres"] <= 1e-5
    assert len(rec["checked_cols"]) == 4


def test_chip_smoke_phase_complex_tiny():
    cs = _load_chip_smoke()
    rec = cs.phase_complex("cpu-test", L=4, k=4)
    assert rec["true_relres"] <= 1e-5 and rec["dtype"] == "complex64"


def test_chip_smoke_phase_failure_raises():
    """A result outside its tolerance raises instead of passing quietly."""
    cs = _load_chip_smoke()
    with pytest.raises(cs.PhaseFailure):
        cs._check("probe", np.array([1e-7, 2e-5]), 1e-5)
    with pytest.raises(cs.PhaseFailure):
        cs._check("probe", np.array([np.nan]), 1e-5)


def test_chip_smoke_four_cards_on_fake_mesh():
    """The four-card phase on 4 of the 8 fake CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    cs = _load_chip_smoke()
    rec = cs.phase_four_cards("cpu-test", shape=(16, 16, 16), D=4)
    assert rec["devices"] == 4
    assert rec["true_relres"] <= 1e-5 and rec["single_true_relres"] <= 1e-5
    assert abs(rec["iterations"] - rec["single_iterations"]) <= 2
