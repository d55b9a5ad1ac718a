"""Structural causal model: a deterministic conv autoencoder with
counterfactual interventions.

Port of ``deep_active_inference_mc_tpu/models/causal.py`` as an
``nn.Module``:

  encoder: 3 stride-2 SAME convs (32, 64, 128 channels, kernel 4, ReLU),
           NHWC flatten, FC to s_dim
  decoder: FC (ReLU) to 128 x (res/8)^2, NHWC reshape, 2 stride-2 SAME
           transposed convs (64, 32, ReLU), one more to C channels, sigmoid
  counterfactual(x, intervention) = decode(encode(x) + intervention)

Observations are NCHW. For kernel 4 at stride 2 on an even input, Flax's
SAME padding is one row and column on each side, so the conv is
``padding=1`` and the transposed conv is ``conv_transpose2d(stride=2,
padding=1)`` with the spatially flipped kernel (``utils/convert.py`` flips
it), which gives exactly twice the input size.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deep_active_inference_mc_torch.models.networks import he_uniform_init_

ENC_CHANNELS = (32, 64, 128)
DEC_CHANNELS = (64, 32)


class StructuralCausalModel(nn.Module):
    """Deterministic AE over observations with latent interventions."""

    def __init__(self, s_dim: int = 10, colour_channels: int = 1, resolution: int = 64):
        super().__init__()
        if resolution % 8 != 0:
            raise ValueError("resolution must be divisible by 8")
        self.s_dim = s_dim
        self.sp = resolution // 8
        chans = (colour_channels,) + ENC_CHANNELS
        self.enc_convs = nn.ModuleList([
            nn.Conv2d(chans[i], chans[i + 1], 4, stride=2, padding=1) for i in range(3)])
        self.enc_fc = nn.Linear(128 * self.sp * self.sp, s_dim)
        self.dec_fc = nn.Linear(s_dim, 128 * self.sp * self.sp)
        dchans = (128,) + DEC_CHANNELS + (colour_channels,)
        self.dec_convs = nn.ModuleList([
            nn.ConvTranspose2d(dchans[i], dchans[i + 1], 4, stride=2, padding=1)
            for i in range(3)])

    def init(self, generator: torch.Generator) -> "StructuralCausalModel":
        """Seeded He-uniform init (Flax fan-in), zero biases."""
        he_uniform_init_(self, generator)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in self.enc_convs:
            h = F.relu(conv(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten
        return self.enc_fc(h)

    def decode(self, s: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.dec_fc(s))
        h = h.reshape(h.shape[0], self.sp, self.sp, 128).permute(0, 3, 1, 2)  # NHWC reshape
        for i, conv in enumerate(self.dec_convs):
            h = conv(h)
            if i < 2:
                h = F.relu(h)
        return torch.sigmoid(h)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(reconstruction, latent)."""
        s = self.encode(x)
        return self.decode(s), s

    def counterfactual(self, x: torch.Tensor, intervention: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """do(s := s + intervention): re-decode under a latent shift.
        Returns (decoded, intervened latent)."""
        s_intervened = self.encode(x) + intervention
        return self.decode(s_intervened), s_intervened
