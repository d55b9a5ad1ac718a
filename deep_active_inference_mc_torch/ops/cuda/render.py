"""K1, the fused frame render: CUDA kernel wrapper and its plain version.

Counterpart of ``deep_active_inference_mc_tpu/ops/pallas/render.py``
(the repository's only TPU kernel). ``render_frames(lut, latents,
last_r)`` launches the CUDA kernel (``render.cu``) for tensors on a card:
one launch per render, which reads the (B, 6) int64 latents and computes
each env's sprite index and window offsets itself. It takes the plain
PyTorch version only for tensors on the CPU. There is no fallback on the
card: a failed build, tensor-map encode or launch raises.

Output: (B, 1, 64, 64) float32 frames, NCHW, which are the bytes of the
JAX package's (B, 64, 64, 1) NHWC frames.

Under CUDA graph capture (``utils/graphs.py``) the launch is recorded on
the capturing stream with the LUT's tensor map as a kernel parameter, so a
replay renders from the latents then in the same buffer. The build, the
library's load and the carveout's setting happen at the first launch,
which must come before any capture (a graph's warm-up step): a first
launch under capture raises. ``LAUNCHES`` counts a captured launch once;
the graph helper moves that count to its replays.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES, build

NAME = "render"
RES = raster.RES


def render_frames_plain(lut, latents, last_r) -> torch.Tensor:
    """Plain PyTorch K1: LUT gather over an index-grid window (clamped as
    XLA clamps), then the reward strip via ``torch.where``."""
    windows = raster.gather_windows(lut, raster.sprite_index(latents),
                                    *raster.window_offsets(latents))
    return raster.paint_reward_strip(windows, last_r)


def _check(lut, latents, last_r) -> int:
    """B, after checking what the kernel takes: type, shape and contiguity
    first, then the device."""
    B = latents.shape[0] if latents.dim() else -1
    for name, t, dtype, shape in (
        ("lut", lut, torch.float32, (raster.N_SPRITES, raster.CANVAS, raster.CANVAS)),
        ("latents", latents, torch.int64, (B, 6)),
        ("last_r", last_r, torch.float32, (B,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if not lut.is_cuda:
        raise ValueError("render_frames_cuda needs CUDA tensors")
    for name, t in (("latents", latents), ("last_r", last_r)):
        if t.device != lut.device:
            raise ValueError(f"{name} on {t.device}, lut on {lut.device}")
    return B


@functools.cache
def _entry_point():
    """K1's C entry point, built and loaded at first use."""
    fn = build.load(NAME).daimc_render_frames
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def render_frames_cuda(lut, latents, last_r) -> torch.Tensor:
    """Launch K1 on the current stream of ``lut``'s device."""
    B = _check(lut, latents, last_r)
    out = torch.empty((B, 1, RES, RES), dtype=torch.float32, device=lut.device)
    if B == 0:
        return out
    if _entry_point.cache_info().currsize == 0 and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("K1's first launch came under graph capture: run a warm-up step "
                           "first")
    fn = _entry_point()
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        err = fn(lut.data_ptr(), latents.data_ptr(), last_r.data_ptr(), out.data_ptr(), B,
                 stream)
    if err < 0:
        raise RuntimeError(f"K1 render: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"K1 render launch failed: cudaError_t {err}")
    LAUNCHES[NAME] += 1
    return out


def render_frames(lut, latents, last_r) -> torch.Tensor:
    """(B, 1, 64, 64) frames: K1 on a card, the plain version on the CPU."""
    if lut.is_cuda:
        return render_frames_cuda(lut, latents, last_r)
    return render_frames_plain(lut, latents, last_r)
