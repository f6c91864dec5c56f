"""Persistent XLA compilation cache setup.

The fused frame program holds several large ``lax.sort`` instances, and a
cold compile of it takes far longer than a step. JAX's persistent
compilation cache keeps compiled programs across processes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at the fixed, git-ignored
``<repo>/.jax_cache``: the directory is part of the cache key, so a path
that moved between runs would never hit.

Called automatically by :class:`pipeline.engine.FusionEngine`; safe to call
any time before the first compilation.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_compilation_cache() -> str:
    """Point JAX's persistent cache at ``$JAX_COMPILATION_CACHE_DIR`` or
    ``<repo>/.jax_cache`` and return the directory. Raises if the
    directory cannot be created or JAX refuses the setting."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    import jax
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
