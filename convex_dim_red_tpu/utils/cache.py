"""Persistent XLA compilation cache setup.

Compiling the protocol-scale fit programs takes seconds to minutes;
JAX's persistent compilation cache makes every repeated program (driver
re-runs, benchmark rounds, chip smoke runs) load from disk instead.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there
and this module sets nothing.  Otherwise the cache lives at the fixed
path ``<repo>/.jax_cache`` (listed in ``.gitignore``); the path is part
of the cache's key, so it must not move between runs.
"""

import os

import jax

__all__ = ["enable_compilation_cache", "REPO_CACHE_DIR"]

#: The cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache():
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
