"""Device selection and seeded generators.

Every entry point of the port runs on ``cuda`` unless the caller asks for
the CPU, and never carries on on the CPU when a card was asked for.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and the
    machine has none (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def seeded_generator(device: torch.device, *path: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from an integer path, e.g.
    ``(seed, chunk)``: the port's counterpart of ``jax.random.fold_in``.
    Distinct paths give independent 64-bit seeds (numpy ``SeedSequence``)."""
    seed = int(np.random.SeedSequence([int(p) for p in path]).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen
