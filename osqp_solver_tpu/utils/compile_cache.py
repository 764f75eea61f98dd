"""Persistent XLA compile cache for the entry points (bench, smoke test,
examples, benchmark scripts).

The batched solver and planner programs take long to compile at batch 1024,
so every entry point calls :func:`enable_compile_cache` before its first
compile.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself
and nothing else is configured here.  Otherwise the cache lives at the fixed
path ``<repo>/.jax_cache`` (listed in ``.gitignore``); the path is part of
the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    import jax

    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
