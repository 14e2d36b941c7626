"""Persistent XLA compile cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here. Otherwise the cache lives at one fixed directory
inside the checkout, ``<repo>/.jax_cache`` (git-ignored): the path is
part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(environ=os.environ) -> tuple[str, bool]:
    """(cache directory, whether code has to set it)."""
    env = environ.get(ENV)
    if env:
        return env, False
    return os.path.join(REPO_ROOT, ".jax_cache"), True


def enable() -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir`."""
    import jax
    path, set_here = cache_dir()
    if set_here:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
