"""Persistent XLA compilation cache wiring.

The detect+decode megagraph and the Viterbi kernels take a long time to
compile cold; the reference has no such latency (its sim starts
instantly, reference examples/test_sim.cpp:43). JAX's persistent
compilation cache makes every run after the first start in seconds.

Where the cache lives: `$JAX_COMPILATION_CACHE_DIR` when it is set (JAX
reads it itself, and this module sets no other directory), otherwise
`<repo>/.jax_cache`, a fixed path inside the checkout (the path is part
of what makes a later run find the entries).

Call enable_persistent_cache() before the first jit execution (bench.py,
examples, and the Transmitter/Receiver API do this automatically).
"""

from __future__ import annotations

import os

_ENABLED = False

#: JAX's own cache-location variable; when set, it wins
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`<repo>/.jax_cache`: the checkout's own, git-ignored cache."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def cache_dir() -> str:
    """Where the persistent cache lives (see module docstring)."""
    return os.environ.get(ENV_VAR) or default_cache_dir()


def enable_persistent_cache() -> str | None:
    """Turn on the JAX persistent compilation cache (idempotent).

    Returns the directory used, or None when computation lands on the
    CPU (see below).
    """
    global _ENABLED
    # XLA:CPU caches AOT executables keyed WITHOUT host machine features;
    # replaying an entry compiled on a different host emits "could lead to
    # SIGILL" warnings and is a latent crash. The CPU backend also
    # compiles fast, so the cache only serves the GPU path: skip it when
    # computation lands on the CPU (tests, the virtual-device dry run).
    from .platform import on_gpu
    if not on_gpu():
        return None
    path = cache_dir()
    if _ENABLED:
        return path
    import jax

    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything, however small/fast - the win is aggregate startup
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _ENABLED = True
    return path
