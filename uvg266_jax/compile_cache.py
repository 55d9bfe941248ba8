"""Persistent XLA compilation cache location.

The search programs take seconds to minutes to compile for a 1080p
frame, so every entry point (the CLI, bench.py, chip_smoke.py) keeps
JAX's persistent cache. The cache is keyed by its path, so the path is
fixed: `JAX_COMPILATION_CACHE_DIR` when the environment sets it (JAX
reads that variable itself), otherwise `<checkout>/.jax_cache`.
"""
from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory
    and return that directory. Sets nothing when
    JAX_COMPILATION_CACHE_DIR is set."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
