"""JAX runtime configuration shared by the entry points (daemons, bench,
tools, chip_smoke.py).

The persistent compilation cache turns repeat launches of a daemon from
a cold compile of its block program into a load.  It lives where
``JAX_COMPILATION_CACHE_DIR`` says when that is set (JAX reads it itself;
nothing here overrides it), and otherwise at one fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in .gitignore): the path is part
of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["configure_jax", "DEFAULT_CACHE_DIR", "require_gpu"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_jax(cpu: bool = False, cache: bool = True) -> None:
    """Call before any jax array work in an entry point.

    cpu: pin this process to the host CPU backend (apps whose work is
    host-side, so that they do not reserve an accelerator's memory)."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    if cache:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            try:
                os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
            except OSError:     # read-only checkout: run without a cache
                return
            jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def require_gpu() -> dict:
    """The device a measurement runs on, or an error if it is not a GPU
    (a measurement path never falls back to the CPU).  Returns platform,
    device_kind and count as JAX reports them, and `card`: the first
    card's "name, power limit" from nvidia-smi, printed beside every
    number because a card set below its power limit runs slower."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (first device: {devs[0]}); this measures "
            "a CUDA card only")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out or not out[0].strip():
        raise RuntimeError("nvidia-smi printed no card")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": out[0].strip()}
