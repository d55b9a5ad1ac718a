"""Expected free energy G of (state, action) rows, plain.

G = -term0 + term1 + term2 (the paper's a, b, c): term0 ten times the mean over
the reward strip of log_bernoulli(frame, all-left template); term1 minus
the summed Gaussian entropies of the transition prior and of the re-encoded
imagined frame; term2 the Bernoulli pixel entropy of a fresh theta's mean
decode minus that of the first theta's reparameterized sample."""

from __future__ import annotations

import math

import torch

from portbench.reference import nets

LOG_2_PI_E = math.log(2.0 * math.pi * math.e)


def entropy_normal(logvar):
    return 0.5 * (LOG_2_PI_E + logvar)


def entropy_bernoulli(p, d=1e-5):
    return -(1.0 - p) * torch.log(d + 1.0 - p) - p * torch.log(d + p)


def reward_term(po: torch.Tensor) -> torch.Tensor:
    W = po.shape[-1]
    perfect = (torch.arange(W, device=po.device) < W // 2).to(po.dtype)
    x, p = po[..., 0:3, :], perfect  # log_bernoulli(frame, template), as the JAX package
    ll = x * torch.log(1e-5 + p) + (1.0 - x) * torch.log(1e-5 + 1.0 - p)
    return ll.mean(dim=(-3, -2, -1)) * 10.0


def G_mean(P, s0, pi, masks1, masks2, eps_fixed, rate):
    """Single-pass G on transition means, one theta per pass (the masks):
    (G, the first pass's transition means)."""
    mean1, logvar1 = nets.transition(P, pi, s0, masks1, rate)
    po1 = nets.decode(P, mean1)
    _, q_logvar = nets.encode(P, po1)
    term0 = reward_term(po1)
    term1 = -(entropy_normal(logvar1) + entropy_normal(q_logvar)).sum(-1)
    mean2, _ = nets.transition(P, pi, s0, masks2, rate)
    t21 = entropy_bernoulli(nets.decode(P, mean2)).sum(dim=(-3, -2, -1))
    s_fixed = eps_fixed * torch.exp(0.5 * logvar1) + mean1
    t22 = entropy_bernoulli(nets.decode(P, s_fixed)).sum(dim=(-3, -2, -1))
    return -term0 + term1 + (t21 - t22), mean1

