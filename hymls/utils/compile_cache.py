"""Where this checkout keeps its persistent caches.

JAX's persistent compilation cache is used by every entry point (the
driver, bench.py, chip_smoke.py, the tests).  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on import and this
module sets no other directory; otherwise the cache lives in
``<checkout>/.jax_cache``, a fixed path (the path is part of the cache
key, so a directory that moves never hits).
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def checkout_dir() -> str:
    """The directory holding the `hymls` package (the repo root)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def enable(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache; returns its directory.
    Programs that compile faster than `min_compile_secs` are not
    stored."""
    import jax
    path = os.environ.get(ENV_VAR) or os.path.join(checkout_dir(),
                                                   ".jax_cache")
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
