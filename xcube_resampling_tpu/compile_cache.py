"""Where JAX keeps its persistent compilation cache.

The cache key includes the cache path, so a directory that moves between
runs never hits.  ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX
itself and wins; otherwise the cache lives at the fixed path
``<root>/.jax_cache`` (git-ignored).
"""

from __future__ import annotations

import os


def use_compile_cache(root: str | os.PathLike) -> str:
    """Point JAX's persistent compilation cache at ``<root>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set, in which case nothing is
    changed.  Returns the cache directory in effect."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
