"""Closed-form probabilistic math used by the losses and the EFE engine.

Port of ``deep_active_inference_mc_tpu/ops/math.py``; same functions, same
formulas, on tensors. Observations are NCHW here, so ``calc_reward``
slices the strip from the last two axes.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_2_PI = float(np.log(2.0 * np.pi))
LOG_2_PI_E = float(np.log(2.0 * np.pi * np.e))


def kl_div_gaussian_precision(mu1, logvar1, mu2, logvar2, omega):
    """KL[N(mu1, e^logvar1) || N(mu2, e^logvar2 / omega)], elementwise."""
    return (
        0.5 * (logvar2 - torch.log(omega) - logvar1)
        + (torch.exp(logvar1) + torch.square(mu1 - mu2))
        / (2.0 * torch.exp(logvar2) / omega)
        - 0.5
    )


def kl_div_gaussian(mu1, logvar1, mu2, logvar2):
    """Analytic Gaussian KL, elementwise."""
    return (
        0.5 * (logvar2 - logvar1)
        + (torch.exp(logvar1) + torch.square(mu1 - mu2)) / (2.0 * torch.exp(logvar2))
        - 0.5
    )


def kl_div_categorical(q, log_q, log_p, axis=-1):
    """D_KL[Q || P] for categorical distributions given log-probs."""
    return torch.sum(q * (log_q - log_p), dim=axis)


def entropy_normal_from_logvar(logvar):
    """Gaussian differential entropy per dim."""
    return 0.5 * (LOG_2_PI_E + logvar)


def entropy_bernoulli(p, displacement=1e-5):
    """Bernoulli entropy per pixel."""
    return -(1.0 - p) * torch.log(displacement + 1.0 - p) - p * torch.log(
        displacement + p
    )


def log_bernoulli(x, p, displacement=1e-5):
    """Bernoulli log-likelihood per pixel."""
    return x * torch.log(displacement + p) + (1.0 - x) * torch.log(
        displacement + 1.0 - p
    )


def calc_reward(o, resolution=64):
    """Log-likelihood of the reward strip under the "perfect" template
    (rows 0-2 all ones on the left half, zeros on the right).

    Args:
      o: observations (..., C, H, W) with H = W = ``resolution``.
    Returns:
      per-pixel log-Bernoulli over the strip, shape (..., C, 3, W).
    """
    half = resolution // 2
    cols = torch.arange(resolution, device=o.device)
    perfect = (cols < half).to(o.dtype)
    return log_bernoulli(o[..., 0:3, 0:resolution], perfect)


def softmax_multi_with_log(x, single_values=4, eps=1e-20, temperature=10.0):
    """Temperature softmax over groups of ``single_values`` scores plus the
    max-shifted log-numerator: the softmax uses x/temperature, the returned
    log is the unscaled shifted score minus log-sum-exp of the scaled ones
    (the reference's asymmetry, kept for loss parity)."""
    x = x.reshape(-1, single_values)
    x = x - torch.amax(x, dim=1, keepdim=True)
    e_x = torch.exp(x / temperature)
    denom = torch.sum(e_x, dim=1, keepdim=True)
    sm = e_x / denom
    log_sm = x - torch.log(denom + eps)
    return sm, log_sm


def total_correlation(data):
    """0.5*(sum log diag(Cov) - logdet(Cov)). Host-side numpy, eval only."""
    data = np.asarray(data)
    cov = np.cov(data.T)
    return 0.5 * (np.log(np.diag(cov)).sum() - np.linalg.slogdet(cov)[1])


def compute_omega(kl_pi, a, b, c, d):
    """omega = a * (1 - sigmoid((kl_pi - b)/c)) + d."""
    return a * (1.0 - torch.sigmoid((kl_pi - b) / c)) + d
