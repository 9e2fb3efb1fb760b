"""XLA's persistent compile cache: one rule for every process.

Where ``JAX_COMPILATION_CACHE_DIR`` says when it is set (JAX reads the
variable itself, so nothing else is set in code); otherwise
``<checkout>/.cache/xla``, a fixed path (the path is part of a cache entry's
key) that ``.gitignore`` lists. Nothing is read or written outside the
checkout.
"""
from __future__ import annotations

import os

CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".cache")


def enable() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CACHE_ROOT, "xla")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
