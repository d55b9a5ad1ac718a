"""Seeded generators from a path of integers (the run's ``--seed`` first).

A path maps to one 64-bit seed through numpy's ``SeedSequence``, so any
``--seed`` a whole number can be (larger than 32 bits too) gives its own
streams, and two paths that differ anywhere give independent ones."""

from __future__ import annotations

import numpy as np
import torch

# Stream tags under the run's seed.
EPISODE, CHUNK, SAMPLE = 1, 2, 3


def seed_of(*path: int) -> int:
    return int(np.random.SeedSequence([int(p) for p in path]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(device, *path: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed_of(*path))
    return g


def numpy_rng(*path: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(p) for p in path]))
