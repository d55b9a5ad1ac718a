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
layer; ``TransitionNet.draw_masks`` draws them from a generator) or
``None`` for the deterministic net. Kept units are scaled by 1/(1-p), as
Flax does.
Weights start He-uniform with Flax's fan-in (``kh*kw*in`` for both conv
kinds, ``in`` for dense) and zero biases.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

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

    def __init__(self, s_dim: int = 10, pi_dim: int = 4):
        super().__init__()
        self.fc = nn.ModuleList([
            nn.Linear(s_dim, 128), nn.Linear(128, 128), nn.Linear(128, pi_dim),
        ])

    def forward(self, s: torch.Tensor):
        x = F.relu(self.fc[0](s))
        x = F.relu(self.fc[1](x))
        logits = self.fc[2](x)
        q_pi = torch.softmax(logits, dim=-1)
        return logits, q_pi, torch.log(q_pi + 1e-20)


class TransitionNet(nn.Module):
    """(pi, s0) -> (mean, logvar) of s1. ``masks`` samples a model theta
    (MC dropout); ``None`` gives the mean-field net."""

    def __init__(self, s_dim: int = 10, pi_dim: int = 4, hidden: int = 512,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.hidden = hidden
        self.dropout_rate = dropout_rate
        self.fc = nn.ModuleList([
            nn.Linear(pi_dim + s_dim, hidden), nn.Linear(hidden, hidden),
            nn.Linear(hidden, hidden), nn.Linear(hidden, 2 * s_dim),
        ])

    def draw_masks(self, rows: int, generator: torch.Generator, device) -> List[torch.Tensor]:
        return _draw_masks(rows, (self.hidden,) * 3, self.dropout_rate, generator, device)

    def forward(self, pi: torch.Tensor, s0: torch.Tensor, masks: Masks = None):
        x = torch.cat([pi, s0], dim=-1)
        for i in range(3):
            x = F.relu(self.fc[i](x))
            x = _dropout(x, None if masks is None else masks[i], self.dropout_rate)
        mean, logvar = torch.chunk(self.fc[3](x), 2, dim=-1)
        return mean, _clip_logvar(logvar)


class Encoder(nn.Module):
    """Q(s|o): 4 stride-2 SAME convs + 3 FC(256) with dropout -> (mean, logvar)."""

    def __init__(self, s_dim: int = 10, colour_channels: int = 1,
                 resolution: int = 64, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        chans = (colour_channels, 32, 32, 64, 64)
        self.conv = nn.ModuleList([
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2) for i in range(4)
        ])
        flat = (resolution // 16) ** 2 * 64
        self.fc = nn.ModuleList([
            nn.Linear(flat, 256), nn.Linear(256, 256), nn.Linear(256, 256),
            nn.Linear(256, 2 * s_dim),
        ])

    def forward(self, o: torch.Tensor, masks: Masks = None):
        x = o
        for conv in self.conv:
            x = F.relu(conv(F.pad(x, (0, 1, 0, 1))))  # SAME, stride 2
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        for i in range(3):
            x = F.relu(self.fc[i](x))
            x = _dropout(x, None if masks is None else masks[i], self.dropout_rate)
        mean, logvar = torch.chunk(self.fc[3](x), 2, dim=-1)
        return mean, _clip_logvar(logvar)


class Decoder(nn.Module):
    """P(o|s): 3 FC(256) + FC(16*16*64), dropout after each, then 4 SAME
    transposed convs and a sigmoid. Resolution 64 uses a stride-2 third
    deconv, 32 a stride-1 one."""

    def __init__(self, s_dim: int = 10, colour_channels: int = 1,
                 resolution: int = 64, dropout_rate: float = 0.5):
        super().__init__()
        if resolution == 64:
            last_stride = 2
        elif resolution == 32:
            last_stride = 1
        else:
            raise ValueError(f"Unknown resolution {resolution}")
        self.dropout_rate = dropout_rate
        self.fc = nn.ModuleList([
            nn.Linear(s_dim, 256), nn.Linear(256, 256), nn.Linear(256, 256),
            nn.Linear(256, 16 * 16 * 64),
        ])
        spec = ((64, 64, 1), (64, 64, 2), (64, 32, last_stride),
                (32, colour_channels, 1))
        self.deconv = nn.ModuleList([
            nn.ConvTranspose2d(cin, cout, 3, stride=st, padding=1 if st == 1 else 0)
            for cin, cout, st in spec
        ])

    def forward(self, s: torch.Tensor, masks: Masks = None):
        x = s
        for i in range(4):
            x = F.relu(self.fc[i](x))
            x = _dropout(x, None if masks is None else masks[i], self.dropout_rate)
        x = x.reshape(x.shape[0], 16, 16, 64).permute(0, 3, 1, 2).contiguous()
        for i, layer in enumerate(self.deconv):
            n = x.shape[-1]
            x = layer(x)
            if layer.stride[0] == 2:
                x = x[..., : 2 * n, : 2 * n]  # SAME crop of the padding=0 output
            if i < 3:
                x = F.relu(x)
        return torch.sigmoid(x)


class VAE(nn.Module):
    """Encoder + decoder pair."""

    def __init__(self, s_dim: int = 10, colour_channels: int = 1,
                 resolution: int = 64, dropout_rate: float = 0.5):
        super().__init__()
        self.encoder = Encoder(s_dim, colour_channels, resolution, dropout_rate)
        self.decoder = Decoder(s_dim, colour_channels, resolution, dropout_rate)

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
