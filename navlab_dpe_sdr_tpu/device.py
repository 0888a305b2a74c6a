"""Backend selection and the persistent compilation cache.

Every entry point (the CLI, bench.py, chip_smoke.py) pins its backend here
before JAX initializes one. Choosing the GPU never falls back to the CPU:
a run that asked for the card and did not get it fails.
"""

from __future__ import annotations

import os
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_CACHE_DIR = REPO / ".jax_cache"
DEVICE_CHOICES = ("auto", "cpu", "gpu")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the fixed <repo>/.jax_cache
    (a fixed path, so one checkout's runs hit each other's entries)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(DEFAULT_CACHE_DIR))


def use_compile_cache() -> str:
    import jax

    d = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    return d


def select_device(choice: str, cpu_devices: int | None = None):
    """Pin the JAX backend; must run before any backend initializes.

    auto: JAX's own default. cpu: the CPU backend, with `cpu_devices`
    virtual devices when given. gpu: CUDA with the CPU beside it (for
    on-card vs CPU comparisons); raises if no GPU comes up."""
    import jax

    if choice not in DEVICE_CHOICES:
        raise ValueError(f"device must be one of {DEVICE_CHOICES}, "
                         f"got {choice!r}")
    if choice == "cpu":
        jax.config.update("jax_platforms", "cpu")
        if cpu_devices:
            jax.config.update("jax_num_cpu_devices", int(cpu_devices))
    elif choice == "gpu":
        jax.config.update("jax_platforms", "cuda,cpu")
        platform = jax.devices()[0].platform
        if platform != "gpu":
            raise RuntimeError(f"no GPU: JAX's first device is {platform}")
