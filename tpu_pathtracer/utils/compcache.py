"""Persistent XLA compilation cache for the CLI tools and benchmarks.

The first jit of the full render integrator takes seconds to minutes.
JAX's persistent compilation cache stores the compiled executable on disk
keyed by HLO + compile options, so a second process that builds the same
program skips the compile. The reference app pays its (much smaller) CUDA
compile at build time instead (`src/main.cpp` links precompiled kernels).

Where the cache lives:
* `JAX_COMPILATION_CACHE_DIR` set: that directory, and nothing else is
  configured here.
* otherwise: the path the caller passes, or by default `.jax_cache` at the
  root of this checkout, resolved from this module's own location — the
  same directory whatever the working directory, so a later process finds
  what an earlier one cached. '' disables the cache.

Call `enable()` BEFORE the first jit of the process. A cache miss just
compiles as before — the cache never changes results, only latency.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir(path: str | None = None) -> str:
    """The directory enable(path) uses ('' = disabled)."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    return DEFAULT_DIR if path is None else path


def enable(path: str | None = None) -> str:
    """Turn on JAX's on-disk compilation cache; returns its directory
    ('' when disabled)."""
    d = cache_dir(path)
    if not d:
        return d
    import jax

    if os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", d)
        return d
    d = os.path.abspath(d)
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    # default min is 1 s of compile time; render programs always qualify,
    # but keep the bar low so the viewer's small preview jits cache too
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
