"""JAX's persistent compilation cache, at one fixed place per checkout.

Every entry point (bench.py, chip_smoke.py, __graft_entry__.py, the GPU test
run, the scripts under benchmarks/) calls `enable_compile_cache()` before
its first compile. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already
reads it and nothing is changed here. Otherwise the cache lives at
`<repo>/out/jit_cache`: a fixed path, so that processes started from any
working directory share it (`out/` is git-ignored).
"""

from __future__ import annotations

import os

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "out", "jit_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's compile cache at its directory; returns that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
