"""Persistent XLA compilation cache at a fixed place.

Compiling the large programs (blocked factorizations, samplers, the
fused kernels) takes a large share of a cold run.  JAX's persistent
cache keeps compiled executables across processes, but only finds them
again if the directory stays the same from run to run.
"""

from __future__ import annotations

import os

import jax

#: ``<checkout>/.jax_cache`` (listed in .gitignore).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here.  Otherwise the cache goes to
    ``DEFAULT_CACHE_DIR`` and every compilation is kept, however short.
    Call it from entry points (CLI, scripts), not at import.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_CACHE_DIR
