"""Persistent cache of the port's compiled kernels.

Counterpart of ``deep_active_inference_mc_tpu/utils/compcache.py``. The port
compiles nothing at run time except its CUDA kernels (``ops/cuda/build.py``),
which are already cached on disk by a hash of their source and flags; this
module chooses where that cache lives. ``enable_persistent_cache`` points it
at ``path``, else at ``$DAIF_COMP_CACHE``, else keeps the default
``ops/cuda/_build/`` beside the sources. The apps call it at start, as the
JAX apps do.

Under a mesh, ``build_kernels`` lets one rank per host build while the
others wait at a barrier: concurrent builds are safe (each writes a
temporary file and renames it), but wasted.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from deep_active_inference_mc_torch.ops.cuda import KERNELS, build
from deep_active_inference_mc_torch.parallel import comm


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Point the kernel cache at ``path`` or ``$DAIF_COMP_CACHE`` (created
    if missing; idempotent). Returns the cache dir in use, or "" when the
    location is unwritable (the default stays in use)."""
    cache_dir = path or os.environ.get("DAIF_COMP_CACHE")
    if not cache_dir:
        return str(build.BUILD_DIR)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:
        print(f"kernel cache stays at {build.BUILD_DIR} ({cache_dir}: {e})")
        return ""
    build.BUILD_DIR = Path(cache_dir)
    return cache_dir


def build_kernels(mesh) -> None:
    """On a card: local rank 0 builds every kernel, then all ranks meet at
    a barrier (an all-reduce, which every backend carries). A no-op on the
    CPU, where the kernels' plain versions run."""
    if mesh.device.type != "cuda":
        return
    if mesh.local_rank == 0:
        build.build(KERNELS)
    comm.all_reduce_(torch.zeros(1, device=mesh.device))
