"""The encoder's convolutions: CUDA kernel wrapper and its plain version.

``encode_flat(frames, layers)`` runs the four SAME stride-2 ``Conv2d``
layers of ``models/networks.py``'s ``Encoder`` on the (B, C, res, res)
float32 frames and returns the (B, (res/16)^2 * 64) NHWC flatten after the
last ReLU, the input of the encoder's first dense layer. For tensors on a
card it launches ``conv.cu``, three launches by ``STAGES``: layers 1 and 2
(FP32 FMAs, then TF32 tensor cores), layer 3, layer 4 (TF32 tensor cores,
FP32 accumulation); there is no fallback, so a failed build or launch
raises. For tensors on the CPU it runs the plain version:
``networks.conv_chain``, the encoder's NCHW chain through cuDNN, and the
flatten. ``layer_tf32``, ``stage_tf32`` and ``encode_tf32`` compute what the
kernel computes in float64, with its TF32 roundings, and how far from it
the kernel may lie.

The kernel replaces no TPU kernel (the JAX package leaves these convolutions
to XLA). ``Encoder.forward`` takes it where ``ops.cuda.use_kernel`` holds,
as the decoder does: a card, float32 compute, no autograd recording and
cuDNN's TF32 allowed. Every other encode (the losses' with its backward,
bf16, TF32 off) keeps cuDNN.

Under CUDA graph capture the launches are recorded on the capturing stream.
The build, the library's load and the kernels' shared-memory settings
happen at the first launch, which must come before any capture (a graph's
warm-up step); a first launch under capture raises. ``LAUNCHES`` counts a
captured launch once; the graph helper moves that count to its replays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deep_active_inference_mc_torch.ops.cuda import LAUNCHES, build
from deep_active_inference_mc_torch.ops.cuda.deconv import ACCUMULATION, tf32_round

NAME = "conv"
STAGES = ((0, 1), (2,), (3,))  # the layers of each launch
CHANNELS = (32, 32, 64, 64)  # each layer's output channels
# FP32 summation's error in layer 1, as a share of an output's sum of
# |x| |w| + |bias|: at most 27 sequential FMAs (9 taps x 3 colours), each
# rounding to nearest (2^-24 of the running magnitude). The tensor-core
# layers take ``deconv.ACCUMULATION`` (2^-15).
FMA_ACCUMULATION = 2.0 ** -19


# ---------------------------------------------------------------- plain version

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def stage_plain(x: torch.Tensor, layers: Sequence[nn.Conv2d], stage: int) -> torch.Tensor:
    """One launch's function through ``networks.conv_chain``: stage 0 takes
    the NCHW frames, the others the launch before's NHWC output; NHWC out."""
    from deep_active_inference_mc_torch.models import networks  # it imports this module

    x = x if stage == 0 else _nchw(x)
    return _nhwc(networks.conv_chain([layers[i] for i in STAGES[stage]], x, x.dtype))


def encode_flat_plain(frames: torch.Tensor, layers: Sequence[nn.Conv2d]) -> torch.Tensor:
    """The plain version: ``networks.conv_chain`` and the NHWC flatten."""
    from deep_active_inference_mc_torch.models import networks

    y = networks.conv_chain(layers, frames, frames.dtype)
    return _nhwc(y).reshape(y.shape[0], -1)


# ---------------------------------------------------------------- the kernel's precision

def _pre_tf32(x: torch.Tensor, layer: nn.Conv2d, first: bool,
              half: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's pre-activation in float64 on NHWC ``x`` with the
    kernel's operands, and its bound: ``FMA_ACCUMULATION`` (layer 1) or
    ``ACCUMULATION`` x (sum |x| |w| + |bias|), plus sum ``half`` |w| where
    the input is known only to lie within ``half`` of ``x``."""
    from deep_active_inference_mc_torch.models import networks

    w, b = layer.weight.detach().float(), layer.bias.detach().double()
    if not first:
        w = tf32_round(w)
    w = w.double()
    xc = _nchw(x.double())
    pre = networks.conv_same(xc, w, b)
    mag = xc.abs() if half is None else xc.abs() + _nchw(half)
    acc = FMA_ACCUMULATION if first else ACCUMULATION
    bound = acc * networks.conv_same(mag, w.abs(), b.abs())
    if half is not None:
        bound = bound + networks.conv_same(_nchw(half), w.abs(), None)
    return _nhwc(pre), _nhwc(bound)


def layer_tf32(x: torch.Tensor, layer: nn.Conv2d,
               first: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the kernel in float64 from its NHWC input, before the
    kernel rounds its output: (value after bias and ReLU, FP32 summation's
    bound). The operands are the kernel's: the first layer's FP32 frame and
    weights (FP32 FMAs); in the tensor-core layers the input (already TF32,
    as the layer before writes it) and the weights rounded to TF32. They are
    summed exactly; the bound per output is ``FMA_ACCUMULATION`` (layer 1)
    or ``ACCUMULATION`` x (sum |x| |w| + |bias|) (the ReLU does not widen
    it)."""
    pre, bound = _pre_tf32(x, layer, first)
    return F.relu(pre), bound


def _written(pre: torch.Tensor, bound: torch.Tensor, rounded: bool) -> Tuple[torch.Tensor,
                                                                             torch.Tensor]:
    """Where the kernel's written output lies, from the pre-activation's
    value and bound: [lo, hi] after ReLU and, if ``rounded``, the TF32
    rounding (both monotone), as (mid, half width)."""
    lo, hi = F.relu(pre - bound).float(), F.relu(pre + bound).float()
    if rounded:
        lo, hi = tf32_round(lo), tf32_round(hi)
    lo, hi = lo.double(), hi.double()
    return (lo + hi) / 2, (hi - lo) / 2


def _rounded(stage: int) -> bool:
    return stage < len(STAGES) - 1  # every output but the flatten feeds tensor cores


def _chain_tf32(x: torch.Tensor, layers: Sequence[nn.Conv2d],
                idx: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers ``idx`` in float64 from NHWC ``x`` with the kernel's
    operands: the last one's (value, bound) before the kernel rounds it,
    each output before it carried as the interval the kernel's FP32 sums
    and TF32 roundings may have put it in (``_written``)."""
    half = None
    for n, i in enumerate(idx):
        pre, bound = _pre_tf32(x, layers[i], first=i == 0, half=half)
        if n == len(idx) - 1:
            return F.relu(pre), bound
        x, half = _written(pre, bound, rounded=True)


def stage_tf32(x: torch.Tensor, layers: Sequence[nn.Conv2d],
               stage: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch in float64 from its own input (the NCHW frames for stage
    0, else NHWC), before the kernel rounds its output: (value, bound)."""
    return _chain_tf32(_nhwc(x) if stage == 0 else x, layers, STAGES[stage])


def stage_tf32_share(out: torch.Tensor, x: torch.Tensor, layers: Sequence[nn.Conv2d],
                     stage: int) -> torch.Tensor:
    """Per output of ``out = stage_cuda(x, layers, stage)``, float64: its
    distance from ``stage_tf32``'s value, less the half TF32 unit of ``out``
    that the kernel's rounding takes where it rounds, as a share of the
    bound. At most 1 where the kernel sums the model's operands; bf16
    operands, a dropped tap or the pad on the wrong edge give many times
    that."""
    value, bound = stage_tf32(x, layers, stage)
    return tf32_share(out, value, bound, _rounded(stage))


def tf32_share(out: torch.Tensor, value: torch.Tensor, bound: torch.Tensor,
               rounded: bool) -> torch.Tensor:
    """|out - value| as a share of ``bound``, less the half TF32 unit of
    ``out`` where the kernel ``rounded`` it; 0 where both are 0 (an output
    whose inputs and bias are all zero)."""
    out = out.double()
    err = (out - value).abs()
    if rounded:
        _, exponent = torch.frexp(out)  # out = m 2^e with 1/2 <= |m| < 1: a unit is 2^(e - 11)
        half_unit = torch.where(out == 0, 0.0, torch.exp2(exponent.double() - 12))
        err = (err - half_unit).clamp_min(0)
    return torch.where(err == 0, 0.0, err / bound)


def encode_tf32(frames: torch.Tensor, layers: Sequence[nn.Conv2d]) -> Tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """``encode_flat_cuda``'s arithmetic in float64, the four layers
    chained as ``_chain_tf32`` chains them: the flatten's (value, bound).
    The kernel's flatten lies within ``bound`` of ``value``."""
    value, bound = _chain_tf32(_nhwc(frames), layers, range(len(layers)))
    return value.reshape(frames.shape[0], -1), bound.reshape(frames.shape[0], -1)


# ---------------------------------------------------------------- the kernel

@functools.cache
def _entry_points():
    """The kernel's C entry points, built and loaded at first use."""
    lib = build.load(NAME)
    l12, s2 = lib.daimc_encoder_l12, lib.daimc_encoder_s2
    l12.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    s2.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    l12.restype = s2.restype = ctypes.c_int
    return l12, s2


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(frames: torch.Tensor, layers: Sequence[nn.Conv2d]) -> None:
    if frames.dtype != torch.float32 or frames.dim() != 4:
        raise ValueError(f"frames: {frames.dtype} {tuple(frames.shape)}, want float32 "
                         f"(B, C, res, res)")
    B, C, res, width = frames.shape
    if res != width or res not in (32, 64) or C not in (1, 3):
        raise ValueError(f"frames: {tuple(frames.shape)}, want (B, 1 or 3, res, res), res 32 or 64")
    if not frames.is_contiguous():
        raise ValueError("frames is not contiguous")
    cin = C
    for i, layer in enumerate(layers):
        for name, t in (("weight", layer.weight), ("bias", layer.bias)):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != frames.device:
                raise ValueError(f"layer {i} {name}: {t.dtype} on {t.device}, want contiguous "
                                 f"float32 on {frames.device}")
        if (tuple(layer.weight.shape) != (CHANNELS[i], cin, 3, 3) or layer.stride != (2, 2)
                or layer.padding != (0, 0)):
            raise ValueError(f"layer {i}: weight {tuple(layer.weight.shape)}, stride "
                             f"{layer.stride}, padding {layer.padding}")
        cin = CHANNELS[i]
    if not frames.is_cuda:
        raise ValueError("encode_flat_cuda needs CUDA tensors")


def stage_cuda(x: torch.Tensor, layers: Sequence[nn.Conv2d], stage: int) -> torch.Tensor:
    """One launch of ``conv.cu`` on the current stream of ``x``'s device:
    ``stage_plain``'s function in the kernel's precision."""
    B = x.shape[0]
    width = x.shape[2] if stage == 0 else x.shape[1]
    n = width // (4 if stage == 0 else 2)  # stage 0 holds two stride-2 layers
    out = torch.empty((B, n, n, CHANNELS[STAGES[stage][-1]]), dtype=torch.float32,
                      device=x.device)
    if B == 0:
        return out
    if _entry_points.cache_info().currsize == 0 and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the conv kernel's first launch came under graph capture: run a "
                           "warm-up step first")
    l12, s2 = _entry_points()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        sms = _sms(x.device.index)
        if stage == 0:
            a, b = layers[0], layers[1]
            err = l12(x.data_ptr(), a.weight.data_ptr(), a.bias.data_ptr(), b.weight.data_ptr(),
                      b.bias.data_ptr(), out.data_ptr(), B, x.shape[1], width, sms, stream)
        else:
            layer = layers[STAGES[stage][0]]
            err = s2(x.data_ptr(), layer.weight.data_ptr(), layer.bias.data_ptr(), out.data_ptr(),
                     B, x.shape[3], width, int(_rounded(stage)), sms, stream)
    if err < 0:
        raise ValueError(f"conv kernel: no instantiation for stage {stage}, input "
                         f"{tuple(x.shape)}")
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed: cudaError_t {err}")
    LAUNCHES[NAME] += 1
    return out


def encode_flat_cuda(frames: torch.Tensor, layers: Sequence[nn.Conv2d]) -> torch.Tensor:
    """The kernel: one launch per stage, the last one's NHWC output is the flatten."""
    _check(frames, layers)
    x = frames
    for stage in range(len(STAGES)):
        x = stage_cuda(x, layers, stage)
    return x.reshape(frames.shape[0], -1)


def encode_flat(frames: torch.Tensor, layers: Sequence[nn.Conv2d]) -> torch.Tensor:
    """(B, (res/16)^2 * 64) NHWC flatten: the kernel on a card, the plain version on the CPU."""
    if frames.is_cuda:
        return encode_flat_cuda(frames, layers)
    return encode_flat_plain(frames, layers)
