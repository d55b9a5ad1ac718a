"""Batch makers: the data half of training and evaluation.

Port of ``deep_active_inference_mc_tpu/envs/data.py``:

  make_batch_active_inference   the on-policy generator: EFE over all
                                actions, softmax(-G, T), sample, step with
                                action-repeat.
  make_batch_random             random-policy transitions + ground truth.
  make_batch_random_reward_transitions
                                the reward-imagination probe set (objects
                                pinned at the scoring edge, pushed 'up').
  compare_reward                reward-strip MSE.

Every maker runs under ``torch.no_grad()`` (not inference mode: its
frames, actions and targets feed the training losses) and renders through
``envs.dsprites.render_obs``, which launches kernel K1 on a card. Each draws
all its noise first (``draw_generator`` etc., from the caller's generator)
and then computes deterministically, so a caller can inject the draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.ops import math as m
from deep_active_inference_mc_torch.utils import random as rnd

EnvDraws = env_lib.EnvDraws
EdgeDraws = Tuple[torch.Tensor, torch.Tensor]  # uniform (B,), posY (B,)


@dataclasses.dataclass
class GeneratorDraws:
    """Noise of one ``make_batch_active_inference`` over B envs: the
    randomized envs, the edge curriculum's draws (None when ``edge_frac``
    is 0), the G rollout's draws, the Gumbel noise of the action draw
    (B, pi_dim) and each repeat's respawns (repeats, B, 6)."""

    env: EnvDraws
    edge: Optional[EdgeDraws]
    rollout: efe.RolloutDraws
    gumbel: torch.Tensor
    respawns: torch.Tensor


@dataclasses.dataclass
class RandomDraws:
    """Noise of one ``make_batch_random``: the randomized envs, the
    unnormalized policy (B, pi_dim) uniform draw, the Gumbel noise and the
    respawns."""

    env: EnvDraws
    ppi: torch.Tensor
    gumbel: torch.Tensor
    respawns: torch.Tensor


def draw_edge(batch: int, generator: torch.Generator, device) -> EdgeDraws:
    """The draws of ``pin_edge_fraction``: who is pinned, and where."""
    return (torch.rand((batch,), generator=generator, device=device),
            torch.randint(28, 32, (batch,), generator=generator, device=device))


def draw_generator(agent: ActiveInferenceAgent, cfg: Config, batch: int,
                   generator: torch.Generator, device) -> GeneratorDraws:
    env = env_lib.draw_randomize(generator, batch, device)
    edge = draw_edge(batch, generator, device) if cfg.edge_frac > 0.0 else None
    # CRN shares one set of draws across the action lanes; the tiled
    # estimator has one row per (env, action).
    rows = batch if cfg.crn else batch * agent.pi_dim
    rollout = efe.draw_rollout(agent, rows, rows, generator, device, steps=cfg.deepness,
                               calc_mean=True, samples=cfg.samples,
                               mean_estimator=cfg.gen_mean)
    return GeneratorDraws(
        env, edge, rollout,
        rnd.gumbel((batch, agent.pi_dim), generator, device),
        env_lib.sample_latents(generator, (cfg.repeats, batch), device),
    )


def pin_edge_fraction(env: env_lib.EnvState, frac: float,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[EdgeDraws] = None) -> env_lib.EnvState:
    """Edge curriculum (``cfg.edge_frac``): re-pin ``frac`` of the freshly
    randomized envs to posY in {28..31}, where an 'up' macro step (5
    repeats) crosses the scoring edge, so scoring transitions stop being a
    ~6 % rarity in the mid/down batches. ``draws`` injects (uniform (B,),
    posY (B,))."""
    if draws is None:
        draws = draw_edge(env.batch, generator, env.device)
    u, posy = draws
    latents = env.latents.clone()
    latents[:, 5] = torch.where(u < frac, posy.to(latents.dtype), latents[:, 5])
    return env.replace(latents=latents)


@torch.no_grad()
def make_batch_active_inference(agent: ActiveInferenceAgent, cfg: Config,
                                env: env_lib.EnvState, lut: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                draws: Optional[GeneratorDraws] = None):
    """On-policy data generation. Returns (env', o0, o1, pi0 one-hot,
    log_Ppi); ``env`` only gives the batch size and device (every env is
    re-randomized)."""
    B, A = env.batch, agent.pi_dim
    if draws is None:
        draws = draw_generator(agent, cfg, B, generator, env.device)
    env = env_lib.randomize(env, draws=draws.env)
    if cfg.edge_frac > 0.0:
        env = pin_edge_fraction(env, cfg.edge_frac, draws=draws.edge)
    o0 = env_lib.render_obs(lut, env, cfg.resolution, cfg.colour_channels)

    # EFE of all actions, rows (b, a) with the action fastest. cfg.crn
    # shares the MC noise across the 4 action lanes, so the prior ranks
    # actions by signal and not by independent dropout draws.
    if cfg.crn:
        G_ba, _, _ = efe.calculate_G_4_repeated_crn(
            agent, o0, steps=cfg.deepness, calc_mean=True, samples=cfg.samples,
            mean_estimator=cfg.gen_mean, draws=draws.rollout)
        sum_G = G_ba.reshape(-1)
    else:
        sum_G, _, _ = efe.calculate_G_repeated(
            agent, o0.repeat_interleave(A, dim=0), agent.pi_one_hot.repeat(B, 1),
            steps=cfg.deepness, calc_mean=True, samples=cfg.samples,
            mean_estimator=cfg.gen_mean, draws=draws.rollout)
    Ppi, log_Ppi = m.softmax_multi_with_log(-sum_G, A, temperature=cfg.temperature)
    # Executed action: optionally mixed with a uniform exploration floor and
    # with the habit policy; the top-loss target log_Ppi stays the pure
    # prior either way.
    P_act = Ppi
    if cfg.explore_eps > 0.0:
        P_act = (1.0 - cfg.explore_eps) * Ppi + cfg.explore_eps / A
    if cfg.gen_habit_mix > 0.0:
        P_act = (1.0 - cfg.gen_habit_mix) * P_act + cfg.gen_habit_mix * agent.habitual_net(o0)
    actions = rnd.categorical(torch.log(P_act + 1e-20), noise=draws.gumbel)
    pi0 = F.one_hot(actions, A).to(torch.float32)

    env, _ = env_lib.step_repeated(env, env_lib.to_env_actions(actions, A), cfg.repeats,
                                   respawns=draws.respawns)
    o1 = env_lib.render_obs(lut, env, cfg.resolution, cfg.colour_channels)
    return env, o0, o1, pi0, log_Ppi


def draw_random(cfg: Config, batch: int, generator: torch.Generator, device) -> RandomDraws:
    return RandomDraws(
        env_lib.draw_randomize(generator, batch, device),
        torch.rand((batch, cfg.pi_dim), generator=generator, device=device),
        rnd.gumbel((batch, cfg.pi_dim), generator, device),
        env_lib.sample_latents(generator, (cfg.repeats, batch), device),
    )


@torch.no_grad()
def make_batch_random(cfg: Config, env: env_lib.EnvState, lut: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[RandomDraws] = None):
    """Random-policy transitions with ground truth: fresh randomized envs,
    Ppi ~ normalized U(0,1)^pi_dim, one sampled action, ``repeats`` env
    steps. Returns (env', o0, o1, pi0 one-hot, log_Ppi, S0_real, S1_real)."""
    if draws is None:
        draws = draw_random(cfg, env.batch, generator, env.device)
    env = env_lib.randomize(env, draws=draws.env)
    o0 = env_lib.render_obs(lut, env, cfg.resolution, cfg.colour_channels)
    S0_real = env_lib.ground_truth_factors(env)

    ppi = draws.ppi / torch.sum(draws.ppi, dim=-1, keepdim=True)
    actions = rnd.categorical(torch.log(ppi), noise=draws.gumbel)
    pi0 = F.one_hot(actions, cfg.pi_dim).to(torch.float32)

    env, _ = env_lib.step_repeated(env, env_lib.to_env_actions(actions, cfg.pi_dim),
                                   cfg.repeats, respawns=draws.respawns)
    o1 = env_lib.render_obs(lut, env, cfg.resolution, cfg.colour_channels)
    S1_real = env_lib.ground_truth_factors(env)
    return env, o0, o1, pi0, torch.log(ppi + 1e-20), S0_real, S1_real


@torch.no_grad()
def make_batch_random_reward_transitions(cfg: Config, lut: torch.Tensor, size: int,
                                         generator: Optional[torch.Generator] = None,
                                         env_draws: Optional[EnvDraws] = None,
                                         respawns: Optional[torch.Tensor] = None):
    """Probe set testing whether imagination predicts reward consequences:
    randomized envs pinned at posY=31, pushed 'up'. Returns (o0, o1, pi0
    one-hot). ``env_draws`` and ``respawns`` inject the noise."""
    device = lut.device
    if env_draws is None:
        env_draws = env_lib.draw_randomize(generator, size, device)
    if respawns is None:
        respawns = env_lib.sample_latents(generator, (cfg.repeats, size), device)
    latents, score, last_r = env_draws
    latents = latents.clone()
    latents[:, 5] = 31
    env = env_lib.EnvState(latents, score, last_r)
    o0 = env_lib.render_obs(lut, env, cfg.resolution, cfg.colour_channels)

    actions = torch.zeros((size,), dtype=torch.long, device=device)  # 'up' in both action sets
    env, _ = env_lib.step_repeated(env, actions, cfg.repeats, respawns=respawns)
    o1 = env_lib.render_obs(lut, env, cfg.resolution, cfg.colour_channels)
    return o0, o1, F.one_hot(actions, cfg.pi_dim).to(torch.float32)


def compare_reward(o1: torch.Tensor, po1: torch.Tensor) -> torch.Tensor:
    """MSE restricted to the 3-row reward strip. Frames are NCHW here, so
    the rows are axis 2 (the JAX package's NHWC frames have them on axis 1)."""
    return torch.mean(torch.square(o1[:, :, 0:3] - po1[:, :, 0:3]))
