"""The check that a run loaded nothing of the JAX side."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deep_active_inference_mc_tpu")


def forbidden_loaded(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name (before the first dot) is, whole,
    one of ``FORBIDDEN``: ``deep_active_inference_mc_torch.x`` is not
    ``deep_active_inference_mc_tpu``, and ``jaxtyping`` is not ``jax``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
