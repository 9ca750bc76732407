"""Shared JAX runtime configuration for the CLI's device paths.

Enables the persistent compilation cache: a CLI tool pays XLA
compilation on every process invocation otherwise, which dwarfs the
actual compute for small inputs.  The cache lives in
$JAX_COMPILATION_CACHE_DIR when that is set (JAX reads it itself), and
otherwise at the fixed path <repo>/.jax_cache — a fixed path, because
the cache key includes it.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"

_configured = False


def configure_jax():
    """Idempotent; returns the configured jax module."""
    global _configured
    import jax

    if _configured:
        return jax
    _configured = True
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(REPO_CACHE, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax
