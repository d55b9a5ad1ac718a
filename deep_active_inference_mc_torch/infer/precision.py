"""Top-down precision state and schedules.

Port of ``deep_active_inference_mc_tpu/infer/precision.py``. The three
dynamic scalars of training (gamma, beta_s, beta_o) are 0-d tensors on the
training device, so the annealing schedule and the gamma gate of the down
loss never sync the host; the omega sigmoid's parameters are plain floats.
"""

from __future__ import annotations

import dataclasses

import torch

from deep_active_inference_mc_torch.ops.math import compute_omega


@dataclasses.dataclass
class PrecisionState:
    """Dynamic scalars of the training process (0-d float32 tensors)."""

    gamma: torch.Tensor  # top-down precision mixing weight, annealed 0 -> 0.8
    beta_s: torch.Tensor  # state-KL weight
    beta_o: torch.Tensor  # observation-likelihood weight

    @classmethod
    def create(cls, gamma=0.0, beta_s=1.0, beta_o=1.0, device="cpu") -> "PrecisionState":
        return cls(*(torch.tensor(v, dtype=torch.float32, device=device)
                     for v in (gamma, beta_s, beta_o)))

    def replace(self, **changes) -> "PrecisionState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class OmegaParams:
    """Parameters of the omega sigmoid: a+d = max omega, b = KL[pi] at
    half-sigmoid, c = steepness, d = min."""

    a: float = 1.0
    b: float = 25.0
    c: float = 5.0
    d: float = 1.5

    def __call__(self, kl_pi: torch.Tensor) -> torch.Tensor:
        return compute_omega(kl_pi, self.a, self.b, self.c, self.d)

    @property
    def eval_omega(self) -> float:
        """Fixed omega used in per-epoch evaluation."""
        return self.a / 2.0 + self.d


def anneal_gamma(precision: PrecisionState, epoch: int, gamma_delay: int = 30,
                 gamma_rate: float = 0.01, gamma_max: float = 0.8) -> PrecisionState:
    """gamma += rate after ``gamma_delay`` epochs, capped at ``gamma_max``.
    Called once per epoch; the new gamma stays on the device."""
    if epoch > gamma_delay:
        return precision.replace(
            gamma=torch.clamp(precision.gamma + gamma_rate, max=gamma_max))
    return precision
