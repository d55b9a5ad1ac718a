"""The dSprites sorting game, plain: the sprite table, the frame, the step.

A frozen copy of the JAX package's rules (``envs/raster.py`` and
``envs/dsprites.py`` there): 720 sprites (3 shapes x 6 scales x 40
orientations) rasterized at 4 x 4 supersampling onto a 96 x 96 canvas
centred at (48, 48); a frame is the 64 x 64 window at (32 - posY,
32 - posX) plus the 3-row reward strip. Actions: 0 up (posY + 1; crossing
row 32 scores and respawns), 1 down, 2 left (posX + 1), 3 right (posX - 1),
clamped to the grid; every step decays the last reward by 0.95; a repeated
action freezes an env once it has scored."""

from __future__ import annotations

import functools

import numpy as np
import torch

N_SHAPE, N_SCALE, N_ORIENT, N_POSX, N_POSY = 3, 6, 40, 32, 32
N_SPRITES, CANVAS, CENTER, RES, SS = 720, 96, 48, 64, 4
REWARD_DECAY = 0.95
_SQUARE_HALF = 9.6
_ELLIPSE_A, _ELLIPSE_B = 12.74, 7.29
_HEART_D, _HEART_YLOBE, _HEART_R = 8.7, 0.4, 0.6


def _inside(shape: int, x, y):
    if shape == 0:
        return torch.maximum(torch.abs(x), torch.abs(y)) <= _SQUARE_HALF
    if shape == 1:
        return torch.square(x / _ELLIPSE_A) + torch.square(y / _ELLIPSE_B) <= 1.0
    d, yy = _HEART_D, -y
    r2 = (_HEART_R * d) ** 2
    return ((torch.abs(x) + torch.abs(yy) <= d)
            | (torch.square(x - d / 2) + torch.square(yy - _HEART_YLOBE * d) <= r2)
            | (torch.square(x + d / 2) + torch.square(yy - _HEART_YLOBE * d) <= r2))


@functools.cache
def _lut_cpu() -> torch.Tensor:
    """(720, 96, 96) float32, row shape*240 + scale*40 + orientation,
    built on the CPU in float32."""
    scales = torch.as_tensor(np.linspace(0.5, 1.0, N_SCALE), dtype=torch.float32)
    orients = torch.as_tensor(np.linspace(0.0, 2.0 * np.pi, N_ORIENT), dtype=torch.float32)
    n = CANVAS * SS
    coords = (torch.arange(n, dtype=torch.float32) + 0.5) / SS - 0.5 - CENTER
    ys, xs = coords[None, :, None], coords[None, None, :]
    out = torch.empty((N_SPRITES, CANVAS, CANVAS), dtype=torch.float32)
    for i0 in range(0, N_SPRITES, 48):
        i = torch.arange(i0, i0 + 48)
        scale = scales[(i // N_ORIENT) % N_SCALE][:, None, None]
        c = torch.cos(orients[i % N_ORIENT])[:, None, None]
        s = torch.sin(orients[i % N_ORIENT])[:, None, None]
        xr, yr = (c * xs + s * ys) / scale, (-s * xs + c * ys) / scale
        inside = _inside(i0 // (N_SCALE * N_ORIENT), xr, yr).to(torch.float32)
        frac = inside.reshape(48, CANVAS, SS, CANVAS, SS).mean(dim=(2, 4))
        out[i0:i0 + 48] = (frac >= 0.5).to(torch.float32)
    return out


def lut(device) -> torch.Tensor:
    return _lut_cpu().to(device)


def render(table: torch.Tensor, latents: torch.Tensor, last_r: torch.Tensor) -> torch.Tensor:
    """(B, 1, 64, 64) frames of valid latents: the window, then the strip
    (the left half set to r where r >= 0, the right half to -r where r < 0)."""
    idx = latents[:, 1] * (N_SCALE * N_ORIENT) + latents[:, 2] * N_ORIENT + latents[:, 3]
    r0 = (CENTER - 16) - latents[:, 5]
    c0 = (CENTER - 16) - latents[:, 4]
    ar = torch.arange(RES, device=table.device)
    f = table[idx[:, None, None], (r0[:, None] + ar)[:, :, None],
              (c0[:, None] + ar)[:, None, :]]
    r = last_r[:, None, None]
    rows = ar[None, :, None] < 3
    left = rows & (ar[None, None, :] < RES // 2)
    right = rows & (ar[None, None, :] >= RES // 2)
    f = torch.where(left & (r >= 0), r, f)
    f = torch.where(right & (r < 0), -r, f)
    return f[:, None]


def _reward(shape, pos_x):
    px = pos_x.to(torch.float32)
    square = torch.where(px > 15.0, (15.0 - px) / 16.0, (16.0 - px) / 16.0)
    return torch.where(shape == 0, square, -square)


def step(latents, score, last_r, action, respawn):
    """One step of every env: (latents, score, last_r, scored)."""
    lat = latents.clone()
    px, py = lat[:, 4], lat[:, 5]
    scored = (action == 0) & (py + 1 >= N_POSY)
    reward = _reward(lat[:, 1], px)
    ny = torch.where((action == 0) & ~scored, py + 1, py)
    ny = torch.where(action == 1, torch.clamp(py - 1, min=0), ny)
    nx = torch.where(action == 2, torch.clamp(px + 1, max=N_POSX - 1), px)
    nx = torch.where(action == 3, torch.clamp(px - 1, min=0), nx)
    lat[:, 4], lat[:, 5] = nx, ny
    lat = torch.where(scored[:, None], respawn, lat)
    decayed = last_r * REWARD_DECAY
    return (lat, torch.where(scored, score + reward, score),
            torch.where(scored, reward, decayed), scored)


def step_repeated(latents, score, last_r, action, respawns):
    """``len(respawns)`` steps of one action per env, an env frozen once it
    has scored."""
    done = torch.zeros(latents.shape[0], dtype=torch.bool, device=latents.device)
    for r in range(respawns.shape[0]):
        nl, ns, nr, scored = step(latents, score, last_r, action, respawns[r])
        latents = torch.where(done[:, None], latents, nl)
        score = torch.where(done, score, ns)
        last_r = torch.where(done, last_r, nr)
        done = done | scored
    return latents, score, last_r
