"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX itself keeps the cache there
and this module sets nothing. Otherwise the cache lives at the fixed
``.jax_cache/`` directory of the checkout (a fixed path, so repeated runs
find their entries again).
"""

import os

_CHECKOUT_CACHE = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable_persistent_cache() -> str:
    """Turn the cache on; returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(_CHECKOUT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _CHECKOUT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return _CHECKOUT_CACHE
