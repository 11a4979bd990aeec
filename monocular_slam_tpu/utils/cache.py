"""Persistent XLA compilation cache management.

The reference is an ahead-of-time-compiled C++ binary with zero startup
cost; our per-program XLA compiles are the analogous cost and they dominate
time-to-first-frame. Every entry point (CLI, bench, tests) calls
`enable_compilation_cache()` so each program is compiled once per machine,
not once per process.

Where the cache lives:
  - `JAX_COMPILATION_CACHE_DIR`, when set: JAX reads it itself, and no other
    directory is set in code;
  - otherwise a fixed `<checkout>/.jax_cache` (listed in `.gitignore`). The
    path is part of the cache key, so it never depends on a temporary name,
    a process ID or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_ENABLED = False


def default_cache_dir() -> str:
    """The directory the cache uses: the environment's, else the checkout's."""
    return os.environ.get(ENV_VAR) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache (idempotent).

    Returns the cache dir, or None if it could not be enabled (e.g. a
    read-only filesystem — caching is an optimization, never a requirement).
    """
    global _ENABLED
    import jax

    path = default_cache_dir()
    if _ENABLED:
        return path
    try:
        if not os.environ.get(ENV_VAR):
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        # Cache everything: small programs are numerous here (per-stage jits)
        # and the default min-size/min-time gates would skip most of them.
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:
        return None
    _ENABLED = True
    return path
