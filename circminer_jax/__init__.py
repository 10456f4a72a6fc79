"""circminer-jax: circRNA detection on an accelerator, in JAX."""

import os as _os

# Caches the program writes (XLA compiles, bench set-ups, the auto
# executor's decision) live inside the checkout, in one gitignored
# directory.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache (JAX reads the
    variable itself and no other directory is set here); otherwise the cache
    is ``<checkout>/.cache/xla``.  The cache key includes every array shape,
    so a different genome size compiles again."""
    import jax
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = _os.path.join(CACHE_DIR, "xla")
        _os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return jax.config.jax_compilation_cache_dir


__version__ = "0.1.0"
