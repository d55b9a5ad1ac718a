"""Causal-model training: loss, batch generation, train round, epoch, eval.

Port of ``deep_active_inference_mc_tpu/train/causal.py``:

  - loss: reconstruction MSE against the *next* observation plus a latent
    regularizer kl_div_s = sum(-0.5 * (1 + s - s^2 - e^s)) / B weighted by
    beta_s; the "omega" diagnostic is beta_s*kl + beta_o*recon;
  - batches: random-policy transitions over the batched envs
    (``data.make_batch_random``, 2 renders per round: kernel K1 on a card);
  - one Adam over the whole model at ``l_rate``.

The JAX epoch is one ``lax.scan`` returning the last round's metrics; here
it is a Python loop whose one host sync is the transfer of those metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import data as data_lib
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer.precision import PrecisionState
from deep_active_inference_mc_torch.models.causal import StructuralCausalModel

METRIC_KEYS = ("F", "mse_o", "kl_div_s", "omega")


@dataclasses.dataclass
class CausalTrainState:
    """The model (weights updated in place), its Adam, the precision
    scalars and the envs. ``agent`` and ``opts`` name the model and its
    optimizer as ``utils/checkpoint.py`` reads a train state."""

    model: StructuralCausalModel
    opt: torch.optim.Optimizer
    precision: PrecisionState
    env: env_lib.EnvState

    @property
    def agent(self) -> StructuralCausalModel:
        return self.model

    @property
    def opts(self) -> Dict[str, torch.optim.Optimizer]:
        return {"model": self.opt}


def compute_loss_causal(x_recon: torch.Tensor, o1: torch.Tensor, s: torch.Tensor,
                        precision: PrecisionState):
    """(F, kl_div_s, omega), each 0-d."""
    recon_loss = torch.mean(torch.square(x_recon - o1))
    kl_div_s = torch.sum(
        -0.5 * torch.sum(1.0 + s - torch.square(s) - torch.exp(s), dim=-1)) / s.shape[0]
    omega = precision.beta_s * kl_div_s + precision.beta_o * recon_loss
    F = recon_loss + precision.beta_s * kl_div_s
    return F, kl_div_s, omega


def make_causal_batch(cfg: Config, env: env_lib.EnvState, lut: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[data_lib.RandomDraws] = None):
    """Random-policy transitions: (env', o0, o1, pi0, log_Ppi, S0_real)."""
    env, o0, o1, pi0, log_Ppi, S0_real, _ = data_lib.make_batch_random(
        cfg, env, lut, generator, draws)
    return env, o0, o1, pi0, log_Ppi, S0_real


def create_causal_state(cfg: Config, model: StructuralCausalModel,
                        generator: torch.Generator, device, lr: float = 1e-4
                        ) -> CausalTrainState:
    """Seeded init of the model on ``device`` (``generator`` lives there),
    a fresh Adam at ``lr``, the config's precisions and ``cfg.batch`` fresh
    envs."""
    model.to(device).init(generator)
    return CausalTrainState(
        model=model,
        opt=torch.optim.Adam(model.parameters(), lr=lr),
        precision=PrecisionState.create(cfg.gamma, cfg.beta_s, cfg.beta_o, device),
        env=env_lib.reset(generator, cfg.batch, device),
    )


def causal_round(cfg: Config, state: CausalTrainState, lut: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[data_lib.RandomDraws] = None
                 ) -> Tuple[CausalTrainState, Dict[str, torch.Tensor]]:
    """One round: batch generation and one Adam step (in place). The
    metrics are 0-d tensors on the device, from the pre-update weights."""
    env, o0, o1, _, _, _ = make_causal_batch(cfg, state.env, lut, generator, draws)
    x_recon, s = state.model(o0)
    F, kl, om = compute_loss_causal(x_recon, o1, s, state.precision)
    state.opt.zero_grad(set_to_none=True)
    F.backward()
    state.opt.step()
    state.env = env
    with torch.no_grad():
        metrics = {"F": F.detach(), "mse_o": torch.mean(torch.square(x_recon - o1)),
                   "kl_div_s": kl.detach(), "omega": om.detach()}
    return state, metrics


def make_causal_epoch(cfg: Config, lut: torch.Tensor, rounds: int
                      ) -> Callable[[CausalTrainState, torch.Generator],
                                    Tuple[CausalTrainState, Dict[str, float]]]:
    """``(state, generator) -> (state, last round's metrics as floats)``."""

    def epoch(state, generator):
        metrics = None
        for _ in range(rounds):
            state, metrics = causal_round(cfg, state, lut, generator)
        return state, dict(zip(METRIC_KEYS,
                               torch.stack([metrics[k] for k in METRIC_KEYS]).tolist()))

    return epoch


def make_causal_eval(cfg: Config, lut: torch.Tensor):
    """``evaluate(model, precision, generator)``: the loss on a fresh
    random batch of ``test_size``, the ground truth for the traversals and
    a counterfactual probe (a shift of 2 along latent 0 on 8 frames must
    change the decode). Tensors on the device."""

    @torch.no_grad()
    def evaluate(model: StructuralCausalModel, precision: PrecisionState,
                 generator: torch.Generator):
        env = env_lib.reset(generator, cfg.test_size, lut.device)
        _, o0, o1, _, _, S0_real = make_causal_batch(cfg, env, lut, generator)
        x_recon, s = model(o0)
        F, kl, om = compute_loss_causal(x_recon, o1, s, precision)
        delta = torch.zeros((8, cfg.s_dim), device=lut.device)
        delta[:, 0] = 2.0
        x_cf, _ = model.counterfactual(o0[:8], delta)
        return {
            "F": F,
            "mse_o": torch.mean(torch.square(x_recon - o1)),
            "kl_div_s": kl,
            "omega": om,
            "cf_effect": torch.mean(torch.abs(x_cf - x_recon[:8])),
            "o0": o0,
            "o1": o1,
            "x_recon": x_recon,
            "s": s,
            "S0_real": S0_real,
        }

    return evaluate
