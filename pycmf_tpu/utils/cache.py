"""Persistent XLA compilation cache helper.

Compiling the solver loops takes seconds to tens of seconds per shape;
the persistent cache turns every repeated (bench, smoke, example) run's
compiles into disk hits.

Opt-in by harnesses — the library never mutates global JAX config on
import (sklearn-style libraries must not). When ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already uses that directory and nothing is configured here;
otherwise the cache lives at one fixed path inside the checkout
(``<repo>/.jax_cache``, git-ignored), so every run from the same checkout
finds the previous runs' entries.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Enable JAX's persistent compilation cache; returns the dir in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # Cache every compile, however small: the solver blocks recompile per
    # static (max_iter, eval_every, shape) and add up across a run.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return CACHE_DIR
