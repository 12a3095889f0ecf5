"""Persistent XLA compilation cache for the benches and ``chip_smoke.py``.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache lives at a fixed path inside the checkout,
``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part of what
makes a later run find its entries again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
