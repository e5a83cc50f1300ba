"""Persistent XLA compile cache for the entry points (CLI, bench, smoke).

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and wins:
nothing else is set. Otherwise the cache lives at a fixed path inside the
checkout (``.jax_cache/``, git-ignored), so a later process on the same
checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
