"""Bytes kernel K1 (the frame render, ``ops/cuda/render.cu``) must move.

Frozen copy of ``chip_smoke.py``'s ``render_bound_bytes`` and of the index
arithmetic it reads from ``envs/raster.py``: each LUT pixel that some env's
64 x 64 window covers is read once, 40 B of latents (columns 1-5) and 4 B of
last_r per env, and each 64 x 64 float32 frame is written once."""

from __future__ import annotations

import torch

KERNEL = "render_frames_tma"  # K1 by name in the device trace
N_SCALE, N_ORIENT, N_SPRITES = 6, 40, 720
CANVAS, CENTER, RES, POS_OFFSET = 96, 48, 64, 16


def _start(start: torch.Tensor, size: int, limit: int) -> torch.Tensor:
    start = start.long()
    return torch.where(start < 0, start + size, start).clamp(0, limit)


def bound_bytes(latents: torch.Tensor) -> int:
    """The bytes one render of these (B, 6) latents needs."""
    idx = latents[..., 1] * (N_SCALE * N_ORIENT) + latents[..., 2] * N_ORIENT + latents[..., 3]
    r0 = (CENTER - POS_OFFSET) - latents[..., 5]
    c0 = (CENTER - POS_OFFSET) - latents[..., 4]
    idx = _start(idx, N_SPRITES, N_SPRITES - 1)
    r0 = _start(r0, CANVAS, CANVAS - RES)
    c0 = _start(c0, CANVAS, CANVAS - RES)
    used = torch.zeros((N_SPRITES, CANVAS, CANVAS), dtype=torch.bool, device=latents.device)
    ar = torch.arange(RES, device=latents.device)
    used[idx[:, None, None], (r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]] = True
    B = latents.shape[0]
    return 4 * int(used.sum()) + 44 * B + 4 * B * RES ** 2
