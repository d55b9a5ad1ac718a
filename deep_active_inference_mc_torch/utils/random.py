"""Explicit-generator sampling helpers.

Every random draw of the port goes through a ``torch.Generator`` passed by
the caller (there is no global RNG), and every function that draws also
accepts the draw itself, so tests can feed both packages the same noise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def gumbel(shape: Sequence[int], generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(tuple(shape), generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample indices along the last axis by the Gumbel-max trick (the same
    construction as ``jax.random.categorical``). ``noise`` injects the
    Gumbel draw; otherwise it comes from ``generator``."""
    if noise is None:
        noise = gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1)
