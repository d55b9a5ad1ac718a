"""ActiveInferenceAgent: the three networks and their forwards.

Port of ``deep_active_inference_mc_tpu/infer/agent.py``. The JAX agent is a
holder of module definitions whose forwards take ``params``; here the agent
is an ``nn.Module`` that owns its weights (``utils/convert.py`` loads the
JAX ``params`` into it).

Dropout policy, as in the JAX package: the transition's MC dropout is live
wherever theta is sampled (G, imagination), and the caller passes its
keep-masks; encoder and decoder run without dropout unless masks are given
(only the training losses give them). Serving runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from deep_active_inference_mc_torch.models.networks import (
    VAE,
    HabitNet,
    Masks,
    TransitionNet,
    he_uniform_init_,
    reparameterize,
)
from deep_active_inference_mc_torch.ops import math as m


class ActiveInferenceAgent(nn.Module):
    """Habit net (``top``), transition net (``mid``) and VAE (``down``)."""

    def __init__(self, s_dim: int = 10, pi_dim: int = 4, colour_channels: int = 1,
                 resolution: int = 64):
        super().__init__()
        self.s_dim = s_dim
        self.pi_dim = pi_dim
        self.colour_channels = colour_channels
        self.resolution = resolution
        self.top = HabitNet(s_dim=s_dim, pi_dim=pi_dim)
        self.mid = TransitionNet(s_dim=s_dim, pi_dim=pi_dim)
        self.down = VAE(s_dim=s_dim, colour_channels=colour_channels,
                        resolution=resolution)
        self.register_buffer("pi_one_hot", torch.eye(pi_dim), persistent=False)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> "ActiveInferenceAgent":
        """Seeded He-uniform init (Flax fan-in), zero biases. Draws on the
        generator's device, so init on the CPU and move the agent after."""
        he_uniform_init_(self, generator)
        return self

    # ------------------------------------------------------------- forwards
    def habit(self, s: torch.Tensor):
        """(logits, Q(pi|s), log Q(pi|s))."""
        return self.top(s)

    def transition(self, pi: torch.Tensor, s0: torch.Tensor, masks: Masks = None):
        """(mean, logvar) of P(s1|s0,pi); ``masks`` samples a theta."""
        return self.mid(pi, s0, masks)

    def transition_with_sample(self, pi: torch.Tensor, s0: torch.Tensor,
                               masks: Masks = None,
                               generator: Optional[torch.Generator] = None,
                               eps: Optional[torch.Tensor] = None):
        """(ps1 sample, mean, logvar)."""
        mean, logvar = self.transition(pi, s0, masks)
        return reparameterize(mean, logvar, generator, eps), mean, logvar

    def encode(self, o: torch.Tensor, masks: Masks = None):
        """(mean, logvar) of Q(s|o); no dropout unless masks are given."""
        return self.down.encode(o, masks)

    def encode_with_sample(self, o: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           eps: Optional[torch.Tensor] = None, masks: Masks = None):
        mean, logvar = self.encode(o, masks)
        return reparameterize(mean, logvar, generator, eps), mean, logvar

    def decode(self, s: torch.Tensor, masks: Masks = None):
        """P(o|s) sigmoid frame, NCHW; no dropout unless masks are given."""
        return self.down.decode(s, masks)

    # ------------------------------------------------------------- wrappers
    def habitual_net(self, o: torch.Tensor) -> torch.Tensor:
        """Q(pi | encoder-mean(o))."""
        qs_mean, _ = self.encode(o)
        _, q_pi, _ = self.habit(qs_mean)
        return q_pi

    def imagine_future_from_o(self, o0: torch.Tensor, pi: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              eps_enc: Optional[torch.Tensor] = None,
                              masks: Masks = None,
                              eps_trans: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One-step imagination: encode (sampled) -> transition (sampled
        theta and state) -> decode. Draws come from ``generator`` unless
        injected."""
        s0, _, _ = self.encode_with_sample(o0, generator, eps_enc)
        if masks is None:
            masks = self.mid.draw_masks(o0.shape[0], generator, o0.device)
        ps1, _, _ = self.transition_with_sample(pi, s0, masks, generator, eps_trans)
        return self.decode(ps1)

    def check_reward(self, po: torch.Tensor) -> torch.Tensor:
        """Extrinsic value of an imagined frame: 64-res, mean strip
        log-likelihood x10; 32-res, summed strip log-likelihood."""
        if self.resolution == 64:
            return torch.mean(m.calc_reward(po, 64), dim=(-3, -2, -1)) * 10.0
        return torch.sum(m.calc_reward(po, 32), dim=(-3, -2, -1))

    # ------------------------------------------------------------ utilities
    def param_counts(self) -> Dict[str, int]:
        return {
            name: sum(p.numel() for p in mod.parameters())
            for name, mod in (("top", self.top), ("mid", self.mid), ("down", self.down))
        }
