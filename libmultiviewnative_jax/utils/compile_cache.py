"""One place that decides where JAX keeps its persistent compile cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here changes it.  Otherwise the cache lives in ``<checkout>/.jax_cache``
(git-ignored), a fixed path, so a rerun from the same checkout finds the
programs the last run compiled.  Used by every entry script: bench.py,
chip_smoke.py, benchmarks/ and scripts/.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"

# the directory that holds the package: the repository checkout
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
