"""The three staged variational-free-energy losses.

Port of ``deep_active_inference_mc_tpu/train/losses.py``: the free energy
is split into three independently optimized layer losses, with gradient
isolation at every layer boundary (the ``detach`` calls sit at the call
sites in ``train.loop``).

  F_top  = D_KL[Q(pi|s) || P(pi)]
  F_mid  = D_KL[Q(s1|o1) || P(s1|s0,pi)] * omega
  F_down = -beta_o E[log P(o1|s1)]
           + beta_s * gamma-gated mixture of the KL against the transition
             prior and the KL against N(0,1)

The gamma gate (hard switches at gamma <= 0.05 and >= 0.95, else a convex
mixture) is ``torch.where`` on a tensor gamma, so annealing never syncs
the host. Each loss reads the agent's own weights; autograd reaches only
the layer whose loss it is because the callers detach every input.

Noise: the transition's dropout is live in F_mid; the VAE's only under
``vae_dropout``. A loss draws its noise from ``generator`` unless the
caller injects it (``MidDraws`` / ``DownDraws``; ``StagedDraws`` for a pass
through all three).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.infer.precision import PrecisionState
from deep_active_inference_mc_torch.models.networks import Masks
from deep_active_inference_mc_torch.ops import math as m


@dataclasses.dataclass
class MidDraws:
    """Noise of F_mid over B rows: the transition's keep-masks
    (3 x (B, hidden) bool) and the normal draw (B, s_dim) of the ps1 sample."""

    masks: Masks
    eps: torch.Tensor


@dataclasses.dataclass
class DownDraws:
    """Noise of F_down over B rows: the normal draw (B, s_dim) of the qs1
    sample and, under VAE dropout, the encoder's and decoder's keep-masks."""

    eps: torch.Tensor
    enc_masks: Masks = None
    dec_masks: Masks = None


@dataclasses.dataclass
class StagedDraws:
    """Noise of one pass through all three losses over B rows, as the
    training round and the evaluation make it: the normal draw (B, s_dim)
    of the s0 sample, F_mid's and F_down's draws and, under VAE dropout,
    the encoder keep-masks of the s0 and qs1 passes."""

    eps_s0: torch.Tensor
    mid: MidDraws
    down: DownDraws
    enc0_masks: Masks = None
    enc1_masks: Masks = None


def _normal(agent, rows, generator, device) -> torch.Tensor:
    return torch.randn((rows, agent.s_dim), generator=generator, device=device)


def draw_mid(agent: ActiveInferenceAgent, rows: int, generator: torch.Generator,
             device) -> MidDraws:
    return MidDraws(agent.mid.draw_masks(rows, generator, device),
                    _normal(agent, rows, generator, device))


def draw_down(agent: ActiveInferenceAgent, rows: int, generator: torch.Generator,
              device, vae_dropout: bool) -> DownDraws:
    enc = agent.down.encoder.draw_masks(rows, generator, device) if vae_dropout else None
    eps = _normal(agent, rows, generator, device)
    dec = agent.down.decoder.draw_masks(rows, generator, device) if vae_dropout else None
    return DownDraws(eps, enc, dec)


def draw_staged(agent: ActiveInferenceAgent, rows: int, generator: torch.Generator,
                device, vae_dropout: bool) -> StagedDraws:
    enc_masks = lambda: (agent.down.encoder.draw_masks(rows, generator, device)
                         if vae_dropout else None)
    return StagedDraws(
        enc0_masks=enc_masks(),
        eps_s0=_normal(agent, rows, generator, device),
        enc1_masks=enc_masks(),
        mid=draw_mid(agent, rows, generator, device),
        down=draw_down(agent, rows, generator, device, vae_dropout),
    )


def compute_kl_div_pi(agent: ActiveInferenceAgent, o0: torch.Tensor, log_Ppi: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      masks: Masks = None, eps: Optional[torch.Tensor] = None):
    """D_KL[Q(pi|s(o0)) || P(pi)] from observations, with the encoder's
    dropout live (``masks`` injects its keep-masks, ``eps`` the state draw)."""
    if masks is None:
        masks = agent.down.encoder.draw_masks(o0.shape[0], generator, o0.device)
    qs0, _, _ = agent.encode_with_sample(o0, generator, eps, masks)
    _, q_pi, log_q_pi = agent.habit(qs0)
    return m.kl_div_categorical(q_pi, log_q_pi, log_Ppi)


def compute_loss_top(agent: ActiveInferenceAgent, s: torch.Tensor, log_Ppi: torch.Tensor):
    """F_top = D_KL[Q(pi|s0) || P(pi)]. Returns (F_top, (kl_div_pi,
    kl_div_pi_anal, q_pi))."""
    _, q_pi, log_q_pi = agent.habit(s)
    kl_div_pi_anal = q_pi * (log_q_pi - log_Ppi)
    kl_div_pi = torch.sum(kl_div_pi_anal, dim=-1)
    return kl_div_pi, (kl_div_pi, kl_div_pi_anal, q_pi)


def compute_loss_mid(agent: ActiveInferenceAgent, s0: torch.Tensor,
                     Ppi_sampled: torch.Tensor, qs1_mean: torch.Tensor,
                     qs1_logvar: torch.Tensor, omega: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[MidDraws] = None):
    """F_mid = omega-weighted D_KL[Q(s1) || P(s1|s0,pi)]; the transition
    runs with live dropout (a theta draw per row). Returns (F_mid,
    ((kl_div_s, kl_div_s_anal), ps1, ps1_mean, ps1_logvar))."""
    if draws is None:
        draws = draw_mid(agent, s0.shape[0], generator, s0.device)
    ps1, ps1_mean, ps1_logvar = agent.transition_with_sample(
        Ppi_sampled, s0, draws.masks, eps=draws.eps)
    kl_div_s_anal = m.kl_div_gaussian_precision(
        qs1_mean, qs1_logvar, ps1_mean, ps1_logvar, omega)
    kl_div_s = torch.sum(kl_div_s_anal, dim=-1)
    return kl_div_s, ((kl_div_s, kl_div_s_anal), ps1, ps1_mean, ps1_logvar)


def compute_loss_down(agent: ActiveInferenceAgent, o1: torch.Tensor,
                      ps1_mean: torch.Tensor, ps1_logvar: torch.Tensor, omega: torch.Tensor,
                      precision: PrecisionState, displacement: float = 1e-5,
                      vae_dropout: bool = True,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[DownDraws] = None):
    """F_down = -beta_o log P(o1|s1) + beta_s * gamma-gated KL mixture.
    ``vae_dropout`` gates the encoder/decoder dropout
    (``Config.vae_train_dropout``). Returns (F, (loss_terms, po1, qs1)) with
    loss_terms = (-logpo1_s1, kl_div_s, kl_div_s_anal, kl_div_s_naive,
    kl_div_s_naive_anal)."""
    if draws is None:
        draws = draw_down(agent, o1.shape[0], generator, o1.device, vae_dropout)
    qs1, qs1_mean, qs1_logvar = agent.encode_with_sample(
        o1, eps=draws.eps, masks=draws.enc_masks)
    po1 = agent.decode(qs1, draws.dec_masks)

    # E[log P(o1|s1)]: displaced binary cross-entropy.
    logpo1_s1 = torch.sum(m.log_bernoulli(o1, po1, displacement), dim=(-3, -2, -1))

    zero = torch.zeros((), dtype=qs1_mean.dtype, device=qs1_mean.device)
    kl_div_s_naive_anal = m.kl_div_gaussian_precision(qs1_mean, qs1_logvar, zero, zero, omega)
    kl_div_s_naive = torch.sum(kl_div_s_naive_anal, dim=-1)
    kl_div_s_anal = m.kl_div_gaussian_precision(
        qs1_mean, qs1_logvar, ps1_mean, ps1_logvar, omega)
    kl_div_s = torch.sum(kl_div_s_anal, dim=-1)

    gamma = precision.gamma
    mix = torch.where(
        gamma <= 0.05,
        kl_div_s_naive,
        torch.where(gamma >= 0.95, kl_div_s,
                    gamma * kl_div_s + (1.0 - gamma) * kl_div_s_naive),
    )
    F = -precision.beta_o * logpo1_s1 + precision.beta_s * mix
    loss_terms = (-logpo1_s1, kl_div_s, kl_div_s_anal, kl_div_s_naive, kl_div_s_naive_anal)
    return F, (loss_terms, po1, qs1)
