"""K1, the fused frame render: CUDA kernel wrapper and its plain version.

Counterpart of ``deep_active_inference_mc_tpu/ops/pallas/render.py``
(the repository's only TPU kernel). ``render_frames`` launches the CUDA
kernel (``render.cu``) for tensors on a card and takes the plain PyTorch
version only for tensors on the CPU. There is no fallback on the card: a
failed build or launch raises.

Inputs, as ``frame_inputs`` derives them from the env latents: ``idx``
(B,) LUT row, ``r0``/``c0`` (B,) window offsets (all int32) and ``last_r``
(B,) float32. Output: (B, 1, 64, 64) float32 frames, NCHW, which are the
bytes of the JAX package's (B, 64, 64, 1) NHWC frames.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES, build

NAME = "render"
RES = raster.RES


def frame_inputs(latents: torch.Tensor, last_r: torch.Tensor):
    """(idx, r0, c0, last_r) for K1 from (B, 6) latents and (B,) last_r."""
    row0, col0 = raster.window_offsets(latents)
    return (
        raster.sprite_index(latents).to(torch.int32).contiguous(),
        row0.to(torch.int32).contiguous(),
        col0.to(torch.int32).contiguous(),
        last_r.to(torch.float32).contiguous(),
    )


def render_frames_plain(lut, idx, r0, c0, last_r) -> torch.Tensor:
    """Plain PyTorch K1: LUT gather over an index-grid window (clamped as
    the kernel clamps), then the reward strip via ``torch.where``."""
    return raster.paint_reward_strip(raster.gather_windows(lut, idx, r0, c0), last_r)


def _check(lut, idx, r0, c0, last_r) -> int:
    if not lut.is_cuda:
        raise ValueError("render_frames_cuda needs CUDA tensors")
    B = idx.shape[0]
    for name, t, dtype, shape in (
        ("lut", lut, torch.float32, (raster.N_SPRITES, raster.CANVAS, raster.CANVAS)),
        ("idx", idx, torch.int32, (B,)),
        ("r0", r0, torch.int32, (B,)),
        ("c0", c0, torch.int32, (B,)),
        ("last_r", last_r, torch.float32, (B,)),
    ):
        if t.device != lut.device:
            raise ValueError(f"{name} on {t.device}, lut on {lut.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B


@functools.cache
def _entry_point():
    """K1's C entry point, built and loaded at first use."""
    fn = build.load(NAME).daimc_render_frames
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def render_frames_cuda(lut, idx, r0, c0, last_r) -> torch.Tensor:
    """Launch K1 on the current stream of ``lut``'s device."""
    B = _check(lut, idx, r0, c0, last_r)
    fn = _entry_point()
    out = torch.empty((B, 1, RES, RES), dtype=torch.float32, device=lut.device)
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        err = fn(lut.data_ptr(), idx.data_ptr(), r0.data_ptr(), c0.data_ptr(),
                 last_r.data_ptr(), out.data_ptr(), B, stream)
    if err != 0:
        raise RuntimeError(f"K1 render launch failed: cudaError_t {err}")
    LAUNCHES[NAME] += 1
    return out


def render_frames(lut, idx, r0, c0, last_r) -> torch.Tensor:
    """(B, 1, 64, 64) frames: K1 on a card, the plain version on the CPU."""
    if lut.is_cuda:
        return render_frames_cuda(lut, idx, r0, c0, last_r)
    return render_frames_plain(lut, idx, r0, c0, last_r)
