"""Procedural sprite rasterizer for the dynamic-dSprites environment.

Port of ``deep_active_inference_mc_tpu/envs/raster.py``: the 720 unique
sprites (3 shapes x 6 scales x 40 orientations) are rasterized once into a
(720, 96, 96) look-up table centred at (48, 48); a frame is the 64x64
window of one LUT sprite at an offset set by the position latents, plus the
reward strip.

The LUT is built in float32 on the CPU, with the same arithmetic as the JAX
build, and copied to the device: it equals ``raster.build_sprite_lut()``
bit for bit. (Built on a GPU, ``cos``/``sin`` may differ by an ulp and flip
boundary supersamples.)

Frames in the port are NCHW, ``(B, C, H, W)``. With C=1 that is the same
memory layout as the JAX package's NHWC ``(B, H, W, 1)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from deep_active_inference_mc_torch.utils import profiling

# dSprites latent grid: [color, shape, scale, orientation, posX, posY].
N_COLOR, N_SHAPE, N_SCALE, N_ORIENT, N_POSX, N_POSY = 1, 3, 6, 40, 32, 32
N_SPRITES = N_SHAPE * N_SCALE * N_ORIENT

CANVAS = 96  # LUT canvas; sprite centred at (48, 48)
CENTER = 48
RES = 64  # frame resolution
POS_OFFSET = 16  # sprite centres span pixels [16, 48) of the frame

_SCALE_VALUES = np.linspace(0.5, 1.0, N_SCALE)
_ORIENT_VALUES = np.linspace(0.0, 2.0 * np.pi, N_ORIENT)

_SS = 4  # supersampling factor per axis

# Shape geometry in pixels at scale 1.0 (calibrated in the JAX package).
_SQUARE_HALF = 9.6
_ELLIPSE_A, _ELLIPSE_B = 12.74, 7.29
_HEART_D, _HEART_YLOBE, _HEART_R = 8.7, 0.4, 0.6


def _inside_square(x, y):
    return torch.maximum(torch.abs(x), torch.abs(y)) <= _SQUARE_HALF


def _inside_ellipse(x, y):
    return torch.square(x / _ELLIPSE_A) + torch.square(y / _ELLIPSE_B) <= 1.0


def _inside_heart(x, y):
    # 45deg diamond + two circular lobes (point faces -y in image coords).
    d = _HEART_D
    yy = -y
    diamond = torch.abs(x) + torch.abs(yy) <= d
    r2 = (_HEART_R * d) ** 2
    c1 = torch.square(x - d / 2) + torch.square(yy - _HEART_YLOBE * d) <= r2
    c2 = torch.square(x + d / 2) + torch.square(yy - _HEART_YLOBE * d) <= r2
    return diamond | c1 | c2


_INSIDE = (_inside_square, _inside_ellipse, _inside_heart)


def _rasterize(shape_idx: int, scale_vals: torch.Tensor,
               orient_vals: torch.Tensor) -> torch.Tensor:
    """Rasterize K sprites of one shape onto the 96x96 canvas: (K, 96, 96)."""
    n = CANVAS * _SS
    coords = (torch.arange(n, dtype=torch.float32) + 0.5) / _SS - 0.5 - CENTER
    ys = coords[None, :, None]  # rows
    xs = coords[None, None, :]  # cols
    c = torch.cos(orient_vals)[:, None, None]
    s = torch.sin(orient_vals)[:, None, None]
    scale = scale_vals[:, None, None]
    xr = (c * xs + s * ys) / scale
    yr = (-s * xs + c * ys) / scale
    inside = _INSIDE[shape_idx](xr, yr).to(torch.float32)
    k = inside.shape[0]
    frac = inside.reshape(k, CANVAS, _SS, CANVAS, _SS).mean(dim=(2, 4))
    return (frac >= 0.5).to(torch.float32)


@functools.cache
def _cpu_lut() -> torch.Tensor:
    lut = torch.empty((N_SPRITES, CANVAS, CANVAS), dtype=torch.float32)
    i = torch.arange(N_SPRITES)
    scale_vals = torch.as_tensor(_SCALE_VALUES, dtype=torch.float32)[
        (i // N_ORIENT) % N_SCALE]
    orient_vals = torch.as_tensor(_ORIENT_VALUES, dtype=torch.float32)[
        i % N_ORIENT]
    per_shape = N_SCALE * N_ORIENT
    chunk = 48
    for lo in range(0, N_SPRITES, chunk):
        sl = slice(lo, lo + chunk)
        lut[sl] = _rasterize(lo // per_shape, scale_vals[sl], orient_vals[sl])
    return lut


@profiling.spanned("raster.lut")
def build_sprite_lut(device: str | torch.device = "cpu") -> torch.Tensor:
    """(720, 96, 96) float32 sprite table on ``device``; row
    ``shape*240 + scale*40 + orient``. Built once per process on the CPU
    and copied; treat the result as read-only (the CPU copy is shared)."""
    return _cpu_lut().to(device)


def sprite_index(latents: torch.Tensor) -> torch.Tensor:
    """(..., 6) latents -> LUT row."""
    return (
        latents[..., 1] * (N_SCALE * N_ORIENT)
        + latents[..., 2] * N_ORIENT
        + latents[..., 3]
    )


def window_offsets(latents: torch.Tensor):
    """(row0, col0) of the 64x64 frame window in the 96x96 canvas:
    (32 - posY, 32 - posX). The sprite centre lands at frame pixel
    (16 + posY, 16 + posX)."""
    row0 = (CENTER - POS_OFFSET) - latents[..., 5]
    col0 = (CENTER - POS_OFFSET) - latents[..., 4]
    return row0, col0


def _xla_start(start: torch.Tensor, size: int, limit: int) -> torch.Tensor:
    """XLA's rule for a gather index or a dynamic_slice start: a negative one
    counts once from the end of its axis of ``size``, then it is clamped
    into [0, limit]."""
    start = start.long()
    return torch.where(start < 0, start + size, start).clamp(0, limit)


def clamp_windows(idx: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor):
    """(idx, row0, col0) brought into range as the JAX package's gather and
    dynamic_slice bring them (a no-op for valid latents)."""
    return (_xla_start(idx, N_SPRITES, N_SPRITES - 1),
            _xla_start(row0, CANVAS, CANVAS - RES),
            _xla_start(col0, CANVAS, CANVAS - RES))


def gather_windows(lut: torch.Tensor, idx: torch.Tensor, row0: torch.Tensor,
                   col0: torch.Tensor) -> torch.Tensor:
    """(B, 1, 64, 64): the 64x64 window at (row0, col0) of LUT sprite idx
    per env, after ``clamp_windows``."""
    idx, row0, col0 = clamp_windows(idx, row0, col0)
    ar = torch.arange(RES, device=lut.device)
    rows = (row0[:, None] + ar)[:, :, None]
    cols = (col0[:, None] + ar)[:, None, :]
    return lut[idx[:, None, None], rows, cols][:, None]


def render_sprites_slice(lut: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Gather + per-env window slice, no reward strip: (B, 1, 64, 64)."""
    return gather_windows(lut, sprite_index(latents), *window_offsets(latents))


def paint_reward_strip(frames: torch.Tensor, last_r: torch.Tensor) -> torch.Tensor:
    """Overwrite the 3-row reward strip of NCHW ``frames``: if last_r >= 0,
    rows 0-2 of the left half := last_r; if last_r < 0, rows 0-2 of the
    right half := -last_r. Works at any resolution."""
    B, _, H, W = frames.shape
    r = last_r.reshape(B, 1, 1, 1).to(frames.dtype)
    rows = torch.arange(H, device=frames.device).reshape(1, 1, H, 1)
    cols = torch.arange(W, device=frames.device).reshape(1, 1, 1, W)
    strip = rows < 3
    left = strip & (cols < W // 2)
    right = strip & (cols >= W // 2)
    frames = torch.where(left & (r >= 0.0), r, frames)
    frames = torch.where(right & (r < 0.0), -r, frames)
    return frames
