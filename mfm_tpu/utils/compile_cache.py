"""Persistent XLA compilation cache at one fixed place.

A cold process compiles every program it runs; the pines field alone is a
large part of a short run. A cache is only found again where it was
written, so the directory never moves between runs: it is ``JAX_COMPILATION_CACHE_DIR``
when that is set (JAX reads it itself, and nothing here overrides it), a
directory the caller already configured, and otherwise
``<checkout>/.jax_cache``.
"""

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory. Call before the first compilation."""
    configured = (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or jax.config.jax_compilation_cache_dir
    )
    if configured:
        return configured
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
