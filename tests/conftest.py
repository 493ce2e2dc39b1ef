"""Test env: CPU backend with 8 virtual devices (SURVEY.md §5.2 item 3).

The suite runs on the CPU backend — deterministic, fast, and it provides
the 8-device fake mesh used by the distributed tests. The CPU backend is
forced (with x64 available for the float64 oracles) unless
``JAX_PLATFORMS`` names the GPU: then the process keeps the card, and
``chip_smoke.py`` runs the tests marked ``gpu`` there in-process.

Whether a test can run is decided inside fixtures, never at import or in a
collection hook: every xdist worker must collect the same tests.
"""

import os
import sys

import pytest

import jax

# JAX tracing plus pytest's own frames can exceed CPython's default
# 1000-frame limit on deep solver programs.
sys.setrecursionlimit(10000)

_ON_GPU = any(p in os.environ.get("JAX_PLATFORMS", "")
              for p in ("cuda", "gpu"))

if not _ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    # f64 available for reference solvers / oracles; library code is
    # dtype-explicit so f32 paths are unaffected.
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled-executable memory between test modules.

    The suite compiles ~1000 XLA:CPU programs in one process; past a
    cumulative threshold the NEXT compile has been seen to segfault inside
    backend_compile_and_load. Dropping executables at module boundaries
    keeps the process under that cliff; the persistent compilation cache
    (utils/platform.py) makes the recompiles cheap."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only when the default device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {platform!r}); "
                    "run on the card with `python chip_smoke.py`")


@pytest.fixture
def mesh8():
    """The 8-device fake mesh of the distributed tests."""
    ndev = len(jax.devices())
    if ndev < 8:
        pytest.skip(f"needs the 8-device fake mesh (have {ndev})")
