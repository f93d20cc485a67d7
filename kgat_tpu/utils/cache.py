"""Where XLA's persistent compile cache lives.

A process that compiles the same programs again (the trainer after the
bench, a second epoch run, the serving CLI) loads them from this cache
instead of recompiling. The directory is part of each entry's key, so it
must not move between runs.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, "runs", "jaxcache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here. Otherwise the cache goes to ``runs/jaxcache``
    under the repository root, resolved from this package's location (not
    the working directory)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
