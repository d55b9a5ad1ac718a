"""The three-layer agent's networks as ``nn.Module``s.

Port of ``deep_active_inference_mc_tpu/models/networks.py``:

  - HabitNet       Q(pi | s): MLP 128-128.
  - TransitionNet  P(s1 | s0, pi): MLP 512-512-512 with MC dropout (p=0.5)
                   after every hidden layer.
  - VAE            conv posterior Q(s|o) + deconv likelihood P(o|s).

Observations are NCHW. The Flax modules use SAME padding and NHWC, so:

  - a stride-2 SAME conv on an even input is ``F.pad(x, (0, 1, 0, 1))``
    and an unpadded conv;
  - a SAME ConvTranspose is ``conv_transpose2d`` with the spatially flipped
    kernel (``utils/convert.py`` flips it): ``padding=1`` at stride 1, and
    at stride 2 ``padding=0`` cropped to ``[:2n, :2n]``;
  - the encoder flattens and the decoder reshapes in NHWC order.

Dropout is explicit: a forward takes keep-masks (bool, one per dropout
layer; each network's ``draw_masks`` draws them from a generator) or
``None`` for the deterministic net. Kept units are scaled by 1/(1-p), as
Flax does.
Weights start He-uniform with Flax's fan-in (``kh*kw*in`` for both conv
kinds, ``in`` for dense) and zero biases.

``dtype`` is the compute dtype, with Flax's ``dtype=`` semantics: every
layer casts its input, weight and bias to it (parameters stay float32, so
gradients reach float32 weights), and each head casts its output back to
float32 (logits, the Gaussian heads, the decoder's pre-sigmoid frame), as
the JAX networks do. The casts are explicit, not ``torch.autocast``, which
would keep softmax, exp, log and reductions in float32 on a card and not on
the CPU. Under float32 every cast is a no-op.

Tensor parallel (``parallel/mesh.py``): a ``Dense`` may hold one Megatron
shard, column- or row-parallel. Dropout masks are still drawn at full width
(``draw_masks``), and each column-parallel layer keeps its own columns of
them, so a sharded forward uses the noise of the single-rank one.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deep_active_inference_mc_torch.ops import cuda as cuda_ops
from deep_active_inference_mc_torch.ops.cuda import conv, deconv
from deep_active_inference_mc_torch.parallel.comm import copy_to_model, reduce_from_model

# Both Gaussian heads clip logvar to +-10 so exp(logvar) cannot overflow
# when untrained nets feed samples back autoregressively.
LOGVAR_CLIP = 10.0

Masks = Optional[Sequence[torch.Tensor]]


def _clip_logvar(logvar: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logvar, -LOGVAR_CLIP, LOGVAR_CLIP)


def reparameterize(mean: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + eps * exp(logvar/2); ``eps`` injects the normal draw."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=mean.dtype)
    return eps * torch.exp(logvar * 0.5) + mean


def _draw_masks(rows: int, widths: Sequence[int], rate: float,
                generator: torch.Generator, device) -> List[torch.Tensor]:
    keep = 1.0 - rate
    return [torch.rand((rows, w), generator=generator, device=device) < keep
            for w in widths]


def _dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - rate), 0.0)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``, optionally one Megatron
    shard over ``group`` (``parallel/mesh.py`` sets ``split``):

      - "col": this rank's rows of the weight and of the bias (its output
        columns); the input goes through Megatron's *f*;
      - "row": this rank's columns of the weight (its input rows); the
        partial products are summed by Megatron's *g*, then the whole bias
        is added once.
    """

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.split: Optional[str] = None
        self.group = None
        self.shard = (0, 1)  # (rank, size) in the model group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.split == "row":
            y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)), self.group)
            return y + self.bias.to(dt)
        if self.split == "col":
            x = copy_to_model(x, self.group)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """This shard's output columns of a full-width (..., out) tensor."""
        if self.split != "col":
            return t
        return t.narrow(-1, self.shard[0] * self.out_features, self.out_features)


def _mask(layer: Dense, masks: Masks, i: int) -> Optional[torch.Tensor]:
    return None if masks is None else layer.cols(masks[i])


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Flax's SAME stride-2 conv with a 3x3 kernel on NCHW ``x`` (even n)
    as PyTorch computes it: one zero row and column padded after the end,
    none before the start, then an unpadded conv."""
    return F.conv2d(F.pad(x, (0, 1, 0, 1)), weight, bias, 2)


def conv_chain(layers: Sequence[nn.Conv2d], x: torch.Tensor, dtype) -> torch.Tensor:
    """The encoder's convs on NCHW ``x`` through cuDNN: each layer SAME
    stride 2 in ``dtype``, then ReLU. NCHW out."""
    for layer in layers:
        x = F.relu(conv_same(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype)))
    return x


def deconv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int) -> torch.Tensor:
    """Flax's SAME ConvTranspose with a 3x3 kernel on NCHW ``x`` (n x n) as
    PyTorch computes it: padding 1 at stride 1; at stride 2, padding 0 and
    the output cropped to 2n x 2n, the row and column SAME drops."""
    n = x.shape[-1]
    y = F.conv_transpose2d(x, weight, bias, stride, 1 if stride == 1 else 0)
    return y[..., : 2 * n, : 2 * n] if stride == 2 else y


def deconv_chain(layers: Sequence[nn.ConvTranspose2d], x: torch.Tensor, dtype,
                 frame: bool = True) -> torch.Tensor:
    """The decoder's transposed convs on NCHW ``x`` through cuDNN: each layer
    in ``dtype``, the stride-2 layers cropped to SAME, ReLU after each layer,
    except that with ``frame`` the last layer ends in the sigmoid, computed
    in float32 or the input's wider dtype."""
    for i, layer in enumerate(layers):
        x = deconv_same(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                        layer.stride[0])
        if frame and i == len(layers) - 1:
            return torch.sigmoid(x.to(torch.promote_types(x.dtype, torch.float32)))
        x = F.relu(x)
    return x


def he_uniform_init_(module: nn.Module, generator: torch.Generator) -> None:
    """He-uniform weights with Flax's fan-in, zero biases, for every
    Linear / Conv2d / ConvTranspose2d in ``module``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                fan_in = m.in_features
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()  # (out, in, kh, kw): in*kh*kw
            elif isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()  # (in, out, kh, kw)
            else:
                continue
            bound = math.sqrt(6.0 / fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()


class HabitNet(nn.Module):
    """s -> (logits, Q(pi|s), log Q(pi|s))."""

    def __init__(self, s_dim: int = 10, pi_dim: int = 4, dtype=torch.float32):
        super().__init__()
        self.fc = nn.ModuleList([
            Dense(s_dim, 128, dtype), Dense(128, 128, dtype), Dense(128, pi_dim, dtype),
        ])

    def forward(self, s: torch.Tensor):
        x = F.relu(self.fc[0](s))
        x = F.relu(self.fc[1](x))
        logits = self.fc[2](x).float()
        q_pi = torch.softmax(logits, dim=-1)
        return logits, q_pi, torch.log(q_pi + 1e-20)


class TransitionNet(nn.Module):
    """(pi, s0) -> (mean, logvar) of s1. ``masks`` samples a model theta
    (MC dropout); ``None`` gives the mean-field net."""

    def __init__(self, s_dim: int = 10, pi_dim: int = 4, hidden: int = 512,
                 dropout_rate: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dropout_rate = dropout_rate
        self.fc = nn.ModuleList([
            Dense(pi_dim + s_dim, hidden, dtype), Dense(hidden, hidden, dtype),
            Dense(hidden, hidden, dtype), Dense(hidden, 2 * s_dim, dtype),
        ])

    def draw_masks(self, rows: int, generator: torch.Generator, device) -> List[torch.Tensor]:
        return _draw_masks(rows, (self.hidden,) * 3, self.dropout_rate, generator, device)

    def forward(self, pi: torch.Tensor, s0: torch.Tensor, masks: Masks = None):
        x = torch.cat([pi, s0], dim=-1)
        for i in range(3):
            x = F.relu(self.fc[i](x))
            x = _dropout(x, _mask(self.fc[i], masks, i), self.dropout_rate)
        mean, logvar = torch.chunk(self.fc[3](x).float(), 2, dim=-1)
        return mean, _clip_logvar(logvar)


class Encoder(nn.Module):
    """Q(s|o): 4 stride-2 SAME convs + 3 FC(256) with dropout -> (mean, logvar).

    Where ``ops.cuda.use_kernel`` holds (a card, float32, no autograd
    recording, TF32 allowed), the convs and the NHWC flatten run as the
    hand-written kernel (``ops/cuda/conv.py``); otherwise as ``conv_chain``,
    cuDNN's NCHW chain."""

    def __init__(self, s_dim: int = 10, colour_channels: int = 1,
                 resolution: int = 64, dropout_rate: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        chans = (colour_channels, 32, 32, 64, 64)
        self.conv = nn.ModuleList([
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2) for i in range(4)
        ])
        flat = (resolution // 16) ** 2 * 64
        self.widths = (256, 256, 256)  # of the dropout layers, at full width
        self.fc = nn.ModuleList([
            Dense(flat, 256, dtype), Dense(256, 256, dtype), Dense(256, 256, dtype),
            Dense(256, 2 * s_dim, dtype),
        ])

    def draw_masks(self, rows: int, generator: torch.Generator, device) -> List[torch.Tensor]:
        return _draw_masks(rows, self.widths, self.dropout_rate, generator, device)

    def forward(self, o: torch.Tensor, masks: Masks = None):
        if cuda_ops.use_kernel(o.device, self.compute_dtype):
            x = conv.encode_flat(o.float().contiguous(), self.conv)
        else:
            x = conv_chain(self.conv, o, self.compute_dtype)
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        for i in range(3):
            x = F.relu(self.fc[i](x))
            x = _dropout(x, _mask(self.fc[i], masks, i), self.dropout_rate)
        mean, logvar = torch.chunk(self.fc[3](x).float(), 2, dim=-1)
        return mean, _clip_logvar(logvar)


class Decoder(nn.Module):
    """P(o|s): 3 FC(256) + FC(16*16*64), dropout after each, then 4 SAME
    transposed convs and a sigmoid. Resolution 64 uses a stride-2 third
    deconv, 32 a stride-1 one.

    Where ``ops.cuda.use_kernel`` holds (a card, float32, no
    autograd recording, TF32 allowed), the transposed convs run as the
    hand-written NHWC kernel, which applies the last dense layer's ReLU as
    it loads (it commutes with the dropout's positive scale); otherwise as
    ``deconv_chain``, cuDNN's NCHW chain."""

    def __init__(self, s_dim: int = 10, colour_channels: int = 1,
                 resolution: int = 64, dropout_rate: float = 0.5, dtype=torch.float32):
        super().__init__()
        if resolution == 64:
            last_stride = 2
        elif resolution == 32:
            last_stride = 1
        else:
            raise ValueError(f"Unknown resolution {resolution}")
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.widths = (256, 256, 256, 16 * 16 * 64)  # of the dropout layers, at full width
        self.fc = nn.ModuleList([
            Dense(s_dim, 256, dtype), Dense(256, 256, dtype), Dense(256, 256, dtype),
            Dense(256, 16 * 16 * 64, dtype),
        ])
        spec = ((64, 64, 1), (64, 64, 2), (64, 32, last_stride),
                (32, colour_channels, 1))
        self.deconv = nn.ModuleList([
            nn.ConvTranspose2d(cin, cout, 3, stride=st, padding=1 if st == 1 else 0)
            for cin, cout, st in spec
        ])

    def draw_masks(self, rows: int, generator: torch.Generator, device) -> List[torch.Tensor]:
        return _draw_masks(rows, self.widths, self.dropout_rate, generator, device)

    def forward(self, s: torch.Tensor, masks: Masks = None):
        fused = cuda_ops.use_kernel(s.device, self.compute_dtype)
        x = s
        for i in range(4):
            x = self.fc[i](x)
            if i < 3 or not fused:  # the kernel applies the last ReLU as it loads
                x = F.relu(x)
            x = _dropout(x, _mask(self.fc[i], masks, i), self.dropout_rate)
        if fused:
            return deconv.decode_frames(x.reshape(x.shape[0], *deconv.DENSE_SHAPE), self.deconv)
        x = x.reshape(x.shape[0], 16, 16, 64).permute(0, 3, 1, 2).contiguous()
        return deconv_chain(self.deconv, x, self.compute_dtype)


class VAE(nn.Module):
    """Encoder + decoder pair."""

    def __init__(self, s_dim: int = 10, colour_channels: int = 1,
                 resolution: int = 64, dropout_rate: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.encoder = Encoder(s_dim, colour_channels, resolution, dropout_rate, dtype)
        self.decoder = Decoder(s_dim, colour_channels, resolution, dropout_rate, dtype)

    def encode(self, o: torch.Tensor, masks: Masks = None):
        return self.encoder(o, masks)

    def decode(self, s: torch.Tensor, masks: Masks = None):
        return self.decoder(s, masks)

    def forward(self, o: torch.Tensor, generator: Optional[torch.Generator] = None,
                enc_masks: Masks = None, dec_masks: Masks = None,
                eps: Optional[torch.Tensor] = None):
        """Full autoencode pass: (po, mean, logvar)."""
        mean, logvar = self.encoder(o, enc_masks)
        s = reparameterize(mean, logvar, generator, eps)
        return self.decoder(s, dec_masks), mean, logvar
