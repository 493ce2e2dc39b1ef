"""Platform contract: compile-cache placement, no device-specific code
paths, and operator buffers on the default device."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ------------------------------------------------------- compile cache ----


def _cache_dir_in_subprocess(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    code = ("import blockcg, jax; from blockcg.utils.platform import "
            "enable_compilation_cache as e; "
            "print(jax.config.jax_compilation_cache_dir); print(e())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_cache_dir_follows_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing
    overrides it."""
    want = str(tmp_path / "x")
    assert _cache_dir_in_subprocess(want) == [want, want]


def test_cache_dir_defaults_to_checkout():
    want = str(ROOT / ".jax_compile_cache")
    assert _cache_dir_in_subprocess(None) == [want, want]


def test_checkout_cache_dir_is_ignored_by_git():
    from blockcg.utils.platform import CHECKOUT_CACHE_DIR

    path = pathlib.Path(CHECKOUT_CACHE_DIR)
    assert path.parent == ROOT
    ignored = (ROOT / ".gitignore").read_text().split()
    assert f"{path.name}/" in ignored


# ------------------------------------- no device-specific code paths ----

_PROGRAM_FILES = sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "blockcg").rglob("*.py")) + list(ROOT.glob("*.py"))
    + list((ROOT / "examples").glob("*.py"))
)

# The previous target's name and kernel dialect, spelled in pieces so this
# guard does not match the searches it stands for.
_OLD_CHIP = "t" + "pu"
_FORBIDDEN = (
    "pallas." + _OLD_CHIP, "pl" + _OLD_CHIP, "LIB" + _OLD_CHIP.upper(),
    "interpret" + "=",
) + tuple("BLOCKCG_" + name for name in (
    "NO_PALLAS", "NO_RING", "RING_MAX_MB", "FORCE_RING", "FOLD", "NO_DONATE",
    "NO_BF16_MXU", "FUSED_INTERPRET", "TEST_" + _OLD_CHIP.upper(),
    "COMM_" + _OLD_CHIP.upper(), "COMPILE_CACHE", "NO_COMPILE_CACHE",
))


@pytest.mark.parametrize("relpath", _PROGRAM_FILES)
def test_no_foreign_device_code_path(relpath):
    """No module imports the previous target's Pallas dialect, branches on
    its backend name, or reads a removed kernel-selection option."""
    src = (ROOT / relpath).read_text()
    for word in _FORBIDDEN:
        assert word not in src, f"{relpath} contains {word!r}"
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert node.value.lower() != _OLD_CHIP, (
                f"{relpath}: branches on the {_OLD_CHIP!r} backend name")


# ------------------------------------- buffers on the default device ----


def _complex_builders():
    from blockcg.problems import (
        dirac_bdia, dirac_bell, dirac_gauged, dirac_gauged_cbdia,
        dirac_gauged_matrix,
    )

    return {
        "dirac_bdia": lambda: dirac_bdia(3, dtype=jnp.complex64),
        "dirac_gauged": lambda: dirac_gauged(3, dtype=jnp.complex64),
        "dirac_gauged_matrix": lambda: dirac_gauged_matrix(
            3, dtype=jnp.complex64),
        "dirac_bell": lambda: dirac_bell(3, dtype=jnp.complex64),
        "dirac_gauged_cbdia": lambda: dirac_gauged_cbdia(
            4, dtype=jnp.complex64),
    }


@pytest.mark.parametrize("name", ["dirac_bdia", "dirac_gauged",
                                  "dirac_gauged_matrix", "dirac_bell",
                                  "dirac_gauged_cbdia"])
def test_complex_operator_on_default_device(name):
    """Complex operators live on the default device like real ones (no
    host pinning), and their apply stays there."""
    op = _complex_builders()[name]()
    dev = jax.devices()[0]
    leaves = [x for x in jax.tree.leaves(op) if isinstance(x, jax.Array)]
    assert leaves
    for x in leaves:
        assert x.devices() == {dev}
    X = jnp.ones((op.shape[0], 2), jnp.complex64)
    Y = op.matmat(X)
    assert Y.devices() == {dev}
    assert jnp.iscomplexobj(Y)
