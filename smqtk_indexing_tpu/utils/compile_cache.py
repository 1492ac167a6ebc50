"""
Persistent XLA compilation cache for the repository's entry points
(``chip_smoke.py``, ``bench.py``, ``bench_all.py``).
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

#: Fixed cache directory inside the checkout (listed in .gitignore). The
#: path is part of the cache key, so it never moves between runs.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Keep compiled programs across processes and runs.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed. Otherwise the variable is set to CACHE_DIR (so
    child processes inherit it) and, if JAX is already imported, its
    config too. Call before the first compilation.

    :return: the cache directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(CACHE_DIR)
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_compilation_cache_dir",
                                         str(CACHE_DIR))
    return str(CACHE_DIR)
