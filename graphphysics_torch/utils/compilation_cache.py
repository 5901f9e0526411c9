"""A persistent build cache for the port's kernels (counterpart of
``graphphysics_tpu/utils/compilation_cache.py``).

The JAX package caches XLA executables; the port compiles nothing but its
``nvcc`` libraries (``ops/_native.py``), each named by a hash of its
sources, so pointing their build directory at a directory that outlives
the checkout (``--compilation_cache_dir`` on the CLIs) lets a restart, a
resume or another checkout of the same sources load them instead of
compiling again.
"""

from __future__ import annotations

from pathlib import Path

from graphphysics_torch.ops import _native


def enable_compilation_cache(cache_dir: str) -> Path:
    """Build and load the kernels' libraries under ``cache_dir`` (made if
    missing) from now on; returns it. Call it before the first kernel
    launch: a library already loaded stays loaded from where it was."""
    return _native.set_build_dir(cache_dir)
