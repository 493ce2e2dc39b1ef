"""Platform helpers shared by the package and its scripts."""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_compile_cache (listed in .gitignore): this file lives at
# <checkout>/blockcg/utils/platform.py.
CHECKOUT_CACHE_DIR = str(
    Path(__file__).resolve().parents[2] / ".jax_compile_cache")


def force_cpu_mesh(n_devices: int, *, require: bool = False) -> None:
    """Force an ``n_devices``-device virtual CPU backend.

    Must run before the CPU backend is first initialized (the device-count
    flag is read when the CPU client starts). ``require=True`` raises if
    the backend came up with fewer devices (it was initialized too early
    for the flag to take effect).
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if require:
        ndev = len(jax.devices())
        if ndev < n_devices:
            raise RuntimeError(
                f"needed {n_devices} CPU devices but the backend has {ndev};"
                f" it was initialized before xla_force_host_platform_device_"
                f"count could take effect — set XLA_FLAGS in the environment."
            )


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache directory: JAX
    reads it itself and nothing here overrides it. Otherwise the cache lives
    at ``<checkout>/.jax_compile_cache``. Entry thresholds are zeroed so
    small programs are cached too. Call before the first jit.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = CHECKOUT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
