"""Persistent XLA compilation cache (warm process starts).

The reference starts in milliseconds; a JAX process pays XLA compilation
on the first call of every jitted step instead.  JAX's persistent
compilation cache amortizes that across process restarts: a later
process deserializes the executables instead of compiling them.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR``, when set — and no other directory;
* otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (git-ignored).  The path is part of what makes a later process find
  the entries, so it never depends on a pid, the time or a temp name.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache(min_compile_secs: float = 0.5) -> str:
    """Switch on the on-disk XLA executable cache for this process.

    Call before the first jit execution.  Returns the cache directory.
    """
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
