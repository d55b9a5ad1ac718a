"""The decoder's transposed convolutions: CUDA kernel wrapper and its plain version.

``decode_frames(x, layers)`` runs the four SAME ``ConvTranspose2d`` layers of
``models/networks.py``'s ``Decoder`` on ``x``, the (B, 16, 16, 64) NHWC
output of its last dense layer before that layer's ReLU, and returns the
(B, C, res, res) float32 frame after the sigmoid. For tensors on a card it
launches ``deconv.cu``, one launch per layer, TF32 tensor cores with FP32
accumulation for the three 64-channel inputs and FP32 FMAs for the last
layer; there is no fallback, so a failed build or launch raises. For
tensors on the CPU it runs the plain version: ``networks.deconv_chain``,
the decoder's NCHW chain through cuDNN, with NHWC in and the frame out.
``layer_tf32`` and ``decode_frames_tf32`` compute what the kernel computes
in float64, with its TF32 roundings; ``layer_tf32_share`` and
``FRAME_ATOL`` say how far the kernel may lie from them.

The kernel replaces no TPU kernel (the JAX package leaves these convolutions
to XLA). ``Decoder.forward`` takes it when ``ops.cuda.use_kernel`` holds, as
the encoder's ``conv`` kernel does: a card, float32 compute, no autograd
recording and cuDNN's TF32 allowed, the precision the kernel computes in.
Every other decode (the losses' with its backward, bf16, TF32 off) keeps
cuDNN.

Stride-2 layers run by sub-pixel phase. ``TAPS_1D[s][p]`` lists, for output
index ``s * i + p`` of a SAME transposed conv with PyTorch's (flipped)
kernel, the (input offset, kernel index) pairs it sums: ``out[i]`` takes
``in[i + d] * w[k]``, ``in`` zero outside. The 2-D phases are products of
the 1-D ones (``phases``), and ``packed_taps`` is that table as the kernel
reads it. The last layer's FMA body is written for stride 1's table.

Under CUDA graph capture the launches are recorded on the capturing stream.
The build, the library's load and the kernels' shared-memory settings
happen at the first launch, which must come before any capture (a graph's
warm-up step); a first launch under capture raises. ``LAUNCHES`` counts a
captured launch once; the graph helper moves that count to its replays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deep_active_inference_mc_torch.ops.cuda import LAUNCHES, build

NAME = "deconv"
DENSE_SHAPE = (16, 16, 64)  # the dense layer's output, NHWC, as the first layer reads it

# (input offset, kernel index) pairs of output s * i + p, per stride s and phase p.
TAPS_1D = {
    1: (((1, 0), (0, 1), (-1, 2)),),
    2: (((0, 0), (-1, 2)), ((0, 1),)),
}

Tap = Tuple[int, int, int, int]  # dy, dx, ky, kx


def phases(stride: int) -> List[Tuple[int, int, List[Tap]]]:
    """The 2-D phases (py, px, taps) in the kernel's order, each tap
    (dy, dx, ky, kx): output (s y + py, s x + px) sums
    in[y + dy, x + dx] . w[:, :, ky, kx]."""
    taps = TAPS_1D[stride]
    return [(py, px, [(dy, dx, ky, kx) for dy, ky in taps[py] for dx, kx in taps[px]])
            for py in range(len(taps)) for px in range(len(taps))]


def packed_taps(stride: int) -> List[int]:
    """``phases(stride)`` as deconv.cu's ``Taps``: n_phases, py[4], px[4],
    begin[5], dy[9], dx[9], ky[9], kx[9]."""
    ph = phases(stride)
    taps = [t for _, _, ts in ph for t in ts]
    begin = [0]
    for _, _, ts in ph:
        begin.append(begin[-1] + len(ts))
    pad = 4 - len(ph)
    return [len(ph), *[p[0] for p in ph], *[0] * pad, *[p[1] for p in ph], *[0] * pad,
            *begin, *[begin[-1]] * pad, *[t[i] for i in range(4) for t in taps]]


# ---------------------------------------------------------------- plain version

def layer_plain(x: torch.Tensor, layer: nn.ConvTranspose2d, first: bool = False,
                last: bool = False) -> torch.Tensor:
    """One layer on NHWC ``x`` through ``networks.deconv_chain``: the ReLU
    of the dense output first if ``first``; NHWC out after bias and ReLU, or
    the sigmoid frame if ``last``."""
    from deep_active_inference_mc_torch.models import networks  # it imports this module

    if first:
        x = F.relu(x)
    y = networks.deconv_chain([layer], x.permute(0, 3, 1, 2).contiguous(), x.dtype, frame=last)
    return y if last else y.permute(0, 2, 3, 1)


def decode_frames_plain(x: torch.Tensor, layers: Sequence[nn.ConvTranspose2d]) -> torch.Tensor:
    """The plain version: ``networks.deconv_chain`` behind the dense ReLU
    and one NHWC-to-NCHW permute."""
    from deep_active_inference_mc_torch.models import networks

    return networks.deconv_chain(layers, F.relu(x).permute(0, 3, 1, 2).contiguous(), x.dtype)


# ---------------------------------------------------------------- the kernel's precision

# FP32 summation's error, as a share of an output's sum of |x| |w| + |bias|.
# A tensor-core layer adds its 576 products to FP32 accumulators in 72 mma
# steps of 8, the last layer its 288 in sequential FMAs: at most a unit of
# 2^-23 (truncated) or 2^-24 (rounded) of the running magnitude a step,
# under 2^-15.5 in either. A bf16 operand errs by up to 2^-9 a product.
ACCUMULATION = 2.0 ** -15
# How far the kernel's frame may lie from ``decode_frames_tf32``'s: the
# two differ where the FP32 sums tip an intermediate to the other side of a
# TF32 rounding boundary, a unit of 2^-10 carried through the later layers.
# A bf16 operand, a dropped tap or a misplaced phase each move the frame by
# several times this (PERF.md).
FRAME_ATOL = 2.0 ** -11


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as the kernel's ``cvt.rna.tf32.f32`` rounds."""
    return x.contiguous().view(torch.int32).add(0x1000).bitwise_and(-0x2000).view(torch.float32)


def layer_tf32(x: torch.Tensor, layer: nn.ConvTranspose2d, first: bool = False,
               last: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``layer_cuda``'s arithmetic in float64 from its float32 NHWC input,
    before the kernel rounds its output: (value, FP32 summation's bound).

    The operands are the kernel's: the first layer's input after the dense
    ReLU; in the tensor-core layers, input and weights rounded to TF32; in
    the last layer, FP32 weights. They are summed exactly, then bias and
    ReLU, or the sigmoid frame. The bound per output is ``ACCUMULATION`` x
    (sum |x| |w| + |bias|) (the sigmoid's slope is at most 1/4), plus, in the
    last layer, 2^-22 for the sigmoid's own float32 evaluation."""
    from deep_active_inference_mc_torch.models import networks

    w, b, s = layer.weight.detach().float(), layer.bias.detach().double(), layer.stride[0]
    if first:
        x = F.relu(x)
    if not last:
        x, w = tf32_round(x), tf32_round(w)
    x, w = x.double().permute(0, 3, 1, 2), w.double()
    pre = networks.deconv_same(x, w, b, s)
    bound = ACCUMULATION * networks.deconv_same(x.abs(), w.abs(), b.abs(), s)
    if last:
        return torch.sigmoid(pre), bound + 2.0 ** -22
    return F.relu(pre).permute(0, 2, 3, 1), bound.permute(0, 2, 3, 1)


def layer_tf32_share(out: torch.Tensor, x: torch.Tensor, layer: nn.ConvTranspose2d,
                     first: bool = False, last: bool = False) -> torch.Tensor:
    """Per output of ``out = layer_cuda(x, layer, first, last)``, float64:
    its distance from ``layer_tf32``'s value, less the half TF32 unit of
    ``out`` that the kernel's rounding of a tensor-core layer's output
    takes, as a share of FP32 summation's bound. At most 1 where the kernel
    sums the model's operands; a bf16 operand, a dropped tap or a misplaced
    phase gives many times that."""
    value, bound = layer_tf32(x, layer, first, last)
    out = out.double()
    err = (out - value).abs()
    if not last:
        _, exponent = torch.frexp(out)  # out = m 2^e with 1/2 <= |m| < 1: a unit is 2^(e - 11)
        half_unit = torch.where(out == 0, 0.0, torch.exp2(exponent.double() - 12))
        err = (err - half_unit).clamp_min(0)
    return err / bound


def decode_frames_tf32(x: torch.Tensor, layers: Sequence[nn.ConvTranspose2d]) -> torch.Tensor:
    """``decode_frames_cuda``'s arithmetic in float64: ``layer_tf32``'s
    value by layer, each rounded to TF32 as the kernel writes it for the
    next layer; the float64 frame."""
    for i, layer in enumerate(layers):
        if i:
            x = tf32_round(x.float())
        x, _ = layer_tf32(x, layer, first=i == 0, last=i == len(layers) - 1)
    return x


def phase_conv_plain(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """The phase tables applied in PyTorch: NCHW ``x`` (B, Cin, n, n) to
    the SAME transposed conv's (B, Cout, s n, s n) output, without bias."""
    B, _, n, _ = x.shape
    out = x.new_zeros((B, weight.shape[1], stride * n, stride * n))
    xp = F.pad(x, (1, 1, 1, 1))  # every offset is -1, 0 or +1
    for py, px, taps in phases(stride):
        acc = out[:, :, py::stride, px::stride]
        for dy, dx, ky, kx in taps:
            acc += torch.einsum("bchw,cd->bdhw",
                                xp[:, :, 1 + dy:1 + dy + n, 1 + dx:1 + dx + n],
                                weight[:, :, ky, kx])
    return out


# ---------------------------------------------------------------- the kernel

@functools.cache
def _entry_point():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load(NAME).daimc_deconv_layer
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _taps_array(stride: int):
    packed = packed_taps(stride)
    return (ctypes.c_int32 * len(packed))(*packed)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, layers: Sequence[nn.ConvTranspose2d]) -> None:
    if x.dtype != torch.float32 or x.dim() != 4 or tuple(x.shape[1:]) != DENSE_SHAPE:
        raise ValueError(f"x: {x.dtype} {tuple(x.shape)}, want float32 (B, *{DENSE_SHAPE})")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    if not x.is_cuda:
        raise ValueError("decode_frames_cuda needs CUDA tensors")
    for i, layer in enumerate(layers):
        for name, t in (("weight", layer.weight), ("bias", layer.bias)):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
                raise ValueError(f"layer {i} {name}: {t.dtype} on {t.device}, want contiguous "
                                 f"float32 on {x.device}")
        if layer.kernel_size != (3, 3) or layer.stride[0] != layer.stride[1]:
            raise ValueError(f"layer {i}: kernel {layer.kernel_size}, stride {layer.stride}")


def layer_cuda(x: torch.Tensor, layer: nn.ConvTranspose2d, first: bool = False,
               last: bool = False) -> torch.Tensor:
    """One launch of ``deconv.cu`` on the current stream of ``x``'s device:
    ``layer_plain``'s function in TF32 (FP32 for the last layer)."""
    B, width = x.shape[0], x.shape[1]
    cin, cout = layer.weight.shape[:2]
    s = layer.stride[0]
    shape = (B, cout, width, width) if last else (B, s * width, s * width, cout)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    if _entry_point.cache_info().currsize == 0 and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the deconv kernel's first launch came under graph capture: run a "
                           "warm-up step first")
    fn = _entry_point()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), layer.weight.data_ptr(), layer.bias.data_ptr(), out.data_ptr(),
                 B, cin, cout, s, width, int(first), int(last), _taps_array(s),
                 _sms(x.device.index), stream)
    if err < 0:
        raise ValueError(f"deconv kernel: no instantiation for cin {cin}, cout {cout}, stride "
                         f"{s}, width {width}, first {first}, last {last}")
    if err != 0:
        raise RuntimeError(f"deconv kernel launch failed: cudaError_t {err}")
    LAUNCHES[NAME] += 1
    return out


def decode_frames_cuda(x: torch.Tensor, layers: Sequence[nn.ConvTranspose2d]) -> torch.Tensor:
    """The kernel: one launch per layer."""
    _check(x, layers)
    for i, layer in enumerate(layers):
        x = layer_cuda(x, layer, first=i == 0, last=i == len(layers) - 1)
    return x


def decode_frames(x: torch.Tensor, layers: Sequence[nn.ConvTranspose2d]) -> torch.Tensor:
    """(B, C, res, res) frames: the kernel on a card, the plain version on the CPU."""
    if x.is_cuda:
        return decode_frames_cuda(x, layers)
    return decode_frames_plain(x, layers)
