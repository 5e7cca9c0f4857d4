"""The one place that points JAX's persistent compilation cache at a
directory.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself,
and nothing here overrides it); otherwise the cache lives in ``.jax_cache``
at the repository root, a fixed path so that later runs hit it.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
