"""Device checks and compile-cache setup for the device entry points
(`bench.py`, `bench_e2e.py`, `chip_smoke.py`, `examples/synthetic_eval.py
--device gpu`). Library code never calls these: tests and CPU evaluation
runs stay on whatever platform JAX was given.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def require_gpu(allow_requested_cpu: bool = False) -> str:
    """Return JAX's default backend if it is the GPU; otherwise exit with a
    message. JAX silently falls back to the CPU when it finds no card, so a
    measurement path must refuse that backend. `allow_requested_cpu` lets a
    run proceed on the CPU only when the caller asked for it explicitly with
    JAX_PLATFORMS=cpu (small logic checks, never device numbers)."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu":
        return backend
    if allow_requested_cpu and os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return backend
    hint = (
        "; set JAX_PLATFORMS=cpu to run the small CPU logic check on purpose"
        if allow_requested_cpu
        else ""
    )
    raise SystemExit(
        f"no GPU: JAX's default backend is {backend!r} "
        f"(devices: {jax.devices()}){hint}"
    )


def enable_compile_cache() -> str | None:
    """Persistent compile cache for GPU runs. An explicit
    JAX_COMPILATION_CACHE_DIR wins (JAX reads it itself); otherwise the
    cache lives at a fixed `<repo>/.jax_cache` so repeated runs hit it.
    CPU runs get no cache: long CPU evaluations compile many variable-shape
    programs and the cache grows without bound. Returns the directory in
    use, or None."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
