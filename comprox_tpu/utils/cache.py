"""Persistent XLA compilation cache setup.

Compiling the codec scans takes seconds to minutes per geometry; a
persistent cache makes that a one-time cost per machine.  Called from the
CLI, bench, and smoke entry points before the first jit use.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and JAX reads it
itself.  Otherwise the cache lives at a fixed path inside the checkout
(listed in .gitignore): the path is part of the cache key, so it must not
move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        DEFAULT_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
