"""The agent's networks as plain float32 functions of a Flax params tree.

The tree is read from the configuration's ``torch_export.npz``
(``params/<tree path>``), in Flax's layouts: dense kernels (in, out), conv
kernels HWIO. Convolutions follow ``lax.conv_general_dilated``: a stride-2
SAME conv of a 3 x 3 kernel on an even input pads one row and column at the
end; a SAME transposed conv (Flax ``ConvTranspose``, kernel not flipped) is
a stride-1 conv over the input dilated by the stride and padded by
``lax``'s rule (k=3: (1, 1) at stride 1, (2, 1) at stride 2). Images are
NCHW tensors; the encoder flattens and the decoder reshapes in NHWC order,
as Flax does. Dropout keep-masks scale kept units by 1 / (1 - rate)."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LOGVAR_CLIP = 10.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN while the reference computes."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Params:
    """The Flax params tree of an export, as float32 tensors on ``device``."""

    def __init__(self, path, device):
        with np.load(path) as z:
            self.t: Dict[str, torch.Tensor] = {
                k[len("params/"):]: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                for k in z.files if k.startswith("params/")}

    def dense(self, prefix: str, i: int, x: torch.Tensor) -> torch.Tensor:
        return x @ self.t[f"{prefix}/Dense_{i}/kernel"] + self.t[f"{prefix}/Dense_{i}/bias"]

    def conv(self, prefix: str, kind: str, i: int):
        k = self.t[f"{prefix}/{kind}_{i}/kernel"]  # HWIO
        return k.permute(3, 2, 0, 1).contiguous(), self.t[f"{prefix}/{kind}_{i}/bias"]


def _dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return x if mask is None else torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def _heads(y: torch.Tensor):
    mean, logvar = torch.chunk(y, 2, dim=-1)
    return mean, torch.clamp(logvar, -LOGVAR_CLIP, LOGVAR_CLIP)


def habit(P: Params, s: torch.Tensor):
    """(logits, Q(pi|s))."""
    x = torch.relu(P.dense("top", 0, s))
    x = torch.relu(P.dense("top", 1, x))
    logits = P.dense("top", 2, x)
    return logits, torch.softmax(logits, dim=-1)


def transition(P: Params, pi: torch.Tensor, s0: torch.Tensor,
               masks: Optional[Sequence[torch.Tensor]], rate: float):
    """(mean, logvar) of s1; the input is [pi, s0]."""
    x = torch.cat([pi, s0], dim=-1)
    for i in range(3):
        x = _dropout(torch.relu(P.dense("mid", i, x)), None if masks is None else masks[i], rate)
    return _heads(P.dense("mid", 3, x))


def encode(P: Params, o: torch.Tensor):
    """(mean, logvar) of Q(s|o); o is (B, 1, 64, 64)."""
    x = o
    for i in range(4):
        w, b = P.conv("down/encoder", "Conv", i)
        x = torch.relu(F.conv2d(F.pad(x, (0, 1, 0, 1)), w, b, stride=2))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for i in range(3):
        x = torch.relu(P.dense("down/encoder", i, x))
    return _heads(P.dense("down/encoder", 3, x))


def _conv_transpose_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         stride: int) -> torch.Tensor:
    k = w.shape[-1]
    if stride > 1:
        B, C, H, W = x.shape
        d = x.new_zeros((B, C, (H - 1) * stride + 1, (W - 1) * stride + 1))
        d[:, :, ::stride, ::stride] = x
        x = d
    pad_len = k + stride - 2
    lo = k - 1 if stride > k - 1 else -(-pad_len // 2)
    hi = pad_len - lo
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, b)


DECONV_STRIDES = (1, 2, 2, 1)


def decode(P: Params, s: torch.Tensor) -> torch.Tensor:
    """Sigmoid frames (B, 1, 64, 64)."""
    x = s
    for i in range(4):
        x = torch.relu(P.dense("down/decoder", i, x))
    x = x.reshape(x.shape[0], 16, 16, 64).permute(0, 3, 1, 2)
    for i, st in enumerate(DECONV_STRIDES):
        w, b = P.conv("down/decoder", "ConvTranspose", i)
        x = _conv_transpose_same(x, w, b, st)
        if i < 3:
            x = torch.relu(x)
    return torch.sigmoid(x)
