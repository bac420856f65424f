"""Where JAX keeps its persistent compile cache.

One rule for every entry point (``chip_smoke.py``, ``bench.py``, the CLIs):
if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing here
overrides it; otherwise the cache goes to ``<checkout>/.jax_cache``, a fixed
path (the path is part of the cache key) that ``.gitignore`` lists.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    path = os.environ.get(ENV)
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
