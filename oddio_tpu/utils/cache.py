"""Where JAX keeps its persistent compilation cache for this checkout."""

from __future__ import annotations

import os

#: repository root (the checkout holding the oddio_tpu package)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir(environ=None):
    """``JAX_COMPILATION_CACHE_DIR`` when it is set, otherwise the fixed
    in-checkout ``.jax_cache`` (listed in .gitignore).  A fixed path keeps
    cache keys stable from run to run."""
    env = os.environ if environ is None else environ
    return env.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(_ROOT, ".jax_cache")


def use_compile_cache():
    """Point JAX at ``compile_cache_dir()``.  When the variable is set JAX
    already reads it, so nothing is set here."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
