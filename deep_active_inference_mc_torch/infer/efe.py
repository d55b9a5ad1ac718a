"""Expected-free-energy (EFE, "G") Monte-Carlo estimators.

Port of ``deep_active_inference_mc_tpu/infer/efe.py``: the action-prior
estimators (``calculate_G``, ``calculate_G_mean``, ``calculate_G_repeated``,
``calculate_G_4_repeated``, ``calculate_G_4_repeated_crn``) and the planner's
simulation (``calculate_G_given_trajectory``, ``mcts_step_simulate``).
G = -term0 + term1 + term2:

  term0 (a, extrinsic):       reward-strip log-likelihood of imagined frames.
  term1 (b, state epistemic): -sum[H(s1|pi) + H(s1|o1,pi)], Gaussian
                              entropies of the transition prior and the
                              re-encoded posterior.
  term2 (c, model epistemic): Bernoulli pixel entropy of decodes under
                              fresh thetas minus that under a fixed theta.

MC samples are folded into the batch, sample-major, and only the last
sample's tensors thread onward, as in the JAX package. G rows of the
all-actions estimators are ordered (b, a), action fastest.

Noise: each estimator draws all its noise first (a ``GDraws`` per
evaluation, a ``SimulateDraws`` per planner simulation, from the caller's
generator) and then computes
deterministically, so a caller can inject the draws instead. Only the
transition's dropout is live; encoder and decoder run deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.models.networks import reparameterize
from deep_active_inference_mc_torch.ops import math as m
from deep_active_inference_mc_torch.utils import random as rnd


@dataclasses.dataclass
class GDraws:
    """Noise of one G evaluation over ``rows`` rows (MC samples folded in).

    masks1/masks2: transition keep-masks of pass 1 and of the fresh-theta
    pass 2 (3 x (rows, hidden) bool); eps_fixed: (rows, s_dim) normal draw
    of the fixed-theta sample. The sampled estimator also samples the
    transition in both passes: eps1, eps2 (rows, s_dim)."""

    masks1: Sequence[torch.Tensor]
    masks2: Sequence[torch.Tensor]
    eps_fixed: torch.Tensor
    eps1: Optional[torch.Tensor] = None
    eps2: Optional[torch.Tensor] = None


@dataclasses.dataclass
class RolloutDraws:
    """Noise of a ``steps``-long G rollout: the encoder sample of o (None
    when the rollout starts from the encoder mean) and one GDraws per step."""

    eps0: Optional[torch.Tensor]
    steps: List[GDraws]


def draw_G(agent: ActiveInferenceAgent, rows: int, generator: torch.Generator,
           device, sampled: bool) -> GDraws:
    """Draw one evaluation's noise; ``sampled`` for ``calculate_G``."""

    def normal():
        return torch.randn((rows, agent.s_dim), generator=generator, device=device)

    masks1 = agent.mid.draw_masks(rows, generator, device)
    eps1 = normal() if sampled else None
    masks2 = agent.mid.draw_masks(rows, generator, device)
    eps2 = normal() if sampled else None
    return GDraws(masks1, masks2, normal(), eps1, eps2)


def draw_rollout(agent: ActiveInferenceAgent, batch: int, g_rows: int,
                 generator: torch.Generator, device, steps: int, calc_mean: bool,
                 samples: int, mean_estimator: bool) -> RolloutDraws:
    """Noise of a rollout over ``batch`` observations whose G evaluations
    have ``g_rows`` rows each (before folding in MC samples)."""
    eps0 = None if calc_mean else torch.randn(
        (batch, agent.s_dim), generator=generator, device=device)
    rows = g_rows if mean_estimator else samples * g_rows
    return RolloutDraws(eps0, [
        draw_G(agent, rows, generator, device, sampled=not mean_estimator)
        for _ in range(steps)
    ])


@dataclasses.dataclass
class HabitRolloutDraws:
    """Noise of a ``depth``-step habit rollout over ``rows`` states: the
    Gumbel noise of each step's action draw (depth, rows, pi_dim), each
    step's transition keep-masks, and the normal draw of each step's
    transition sample (depth, rows, s_dim)."""

    gumbel: torch.Tensor
    masks: List[Sequence[torch.Tensor]]
    eps: torch.Tensor


@dataclasses.dataclass
class TrajectoryDraws:
    """Noise of one trajectory G over ``rows`` (time x batch) rows: the
    fresh theta's keep-masks and the draw of its transition sample, and the
    fixed-theta draw."""

    masks: Sequence[torch.Tensor]
    eps: torch.Tensor
    eps_fixed: torch.Tensor


@dataclasses.dataclass
class SimulateDraws:
    """Noise of one ``mcts_step_simulate``: the rollout's and its G's."""

    rollout: HabitRolloutDraws
    trajectory: TrajectoryDraws


def draw_habit_rollout(agent: ActiveInferenceAgent, rows: int, depth: int,
                       generator: torch.Generator, device) -> HabitRolloutDraws:
    gumbel = rnd.gumbel((depth, rows, agent.pi_dim), generator, device)
    masks = [agent.mid.draw_masks(rows, generator, device) for _ in range(depth)]
    eps = torch.randn((depth, rows, agent.s_dim), generator=generator, device=device)
    return HabitRolloutDraws(gumbel, masks, eps)


def draw_trajectory(agent: ActiveInferenceAgent, rows: int,
                    generator: torch.Generator, device) -> TrajectoryDraws:
    masks = agent.mid.draw_masks(rows, generator, device)
    eps, eps_fixed = torch.randn((2, rows, agent.s_dim), generator=generator,
                                 device=device)
    return TrajectoryDraws(masks, eps, eps_fixed)


def draw_simulate(agent: ActiveInferenceAgent, rows: int, depth: int,
                  generator: torch.Generator, device) -> SimulateDraws:
    return SimulateDraws(draw_habit_rollout(agent, rows, depth, generator, device),
                         draw_trajectory(agent, depth * rows, generator, device))


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat along a new leading sample axis and fold it into batch."""
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).reshape(
        (n * x.shape[0],) + tuple(x.shape[1:]))


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape((n, -1) + tuple(x.shape[1:]))


def _sum_entropy_bernoulli(po: torch.Tensor) -> torch.Tensor:
    return torch.sum(m.entropy_bernoulli(po), dim=(-3, -2, -1))


def _state_entropy(ps1_logvar, qs1_logvar) -> torch.Tensor:
    return torch.sum(
        m.entropy_normal_from_logvar(ps1_logvar)
        + m.entropy_normal_from_logvar(qs1_logvar),
        dim=-1,
    )


def calculate_G(agent: ActiveInferenceAgent, s0: torch.Tensor, pi0: torch.Tensor,
                samples: int = 10, generator: Optional[torch.Generator] = None,
                draws: Optional[GDraws] = None):
    """MC estimate of G for (state, action) rows. s0: (B, s_dim); pi0:
    (B, pi_dim) one-hot. Returns (G, [term0, term1, term2], ps1, ps1_mean,
    po1): G and terms (B,); ps1/ps1_mean are the last MC sample's
    transition draw and mean, po1 its decode."""
    if draws is None:
        draws = draw_G(agent, samples * s0.shape[0], generator, s0.device, sampled=True)
    s0_r = _tile(s0, samples)
    pi_r = _tile(pi0, samples)

    # pass 1: theta + state sampling for terms (a) and (b)
    ps1, ps1_mean, ps1_logvar = agent.transition_with_sample(
        pi_r, s0_r, draws.masks1, eps=draws.eps1)
    po1 = agent.decode(ps1)
    _, qs1_logvar = agent.encode(po1)
    term0 = _unfold(agent.check_reward(po1), samples).mean(dim=0)
    term1 = _unfold(-_state_entropy(ps1_logvar, qs1_logvar), samples).mean(dim=0)

    ps1_last = _unfold(ps1, samples)[-1]
    ps1_mean_last = _unfold(ps1_mean, samples)[-1]
    ps1_logvar_last = _unfold(ps1_logvar, samples)[-1]
    po1_last = _unfold(po1, samples)[-1]

    # pass 2: term (c), fresh thetas vs the last sample's fixed theta
    ps1_b, _, _ = agent.transition_with_sample(pi_r, s0_r, draws.masks2, eps=draws.eps2)
    term2_1 = _unfold(_sum_entropy_bernoulli(agent.decode(ps1_b)), samples).mean(dim=0)
    s_fixed = reparameterize(_tile(ps1_mean_last, samples),
                             _tile(ps1_logvar_last, samples), eps=draws.eps_fixed)
    term2_2 = _unfold(_sum_entropy_bernoulli(agent.decode(s_fixed)), samples).mean(dim=0)
    term2 = term2_1 - term2_2

    G = -term0 + term1 + term2
    return G, [term0, term1, term2], ps1_last, ps1_mean_last, po1_last


def calculate_G_mean(agent: ActiveInferenceAgent, s0: torch.Tensor, pi0: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[GDraws] = None):
    """Single-pass G on transition means (one theta still sampled per
    pass). Returns (G, [term0, term1, term2], ps1_mean, po1)."""
    if draws is None:
        draws = draw_G(agent, s0.shape[0], generator, s0.device, sampled=False)
    ps1_mean, ps1_logvar = agent.transition(pi0, s0, draws.masks1)
    po1 = agent.decode(ps1_mean)
    _, qs1_logvar = agent.encode(po1)

    term0 = agent.check_reward(po1)
    term1 = -_state_entropy(ps1_logvar, qs1_logvar)
    # Fresh theta, decode its mean.
    mean_b, _ = agent.transition(pi0, s0, draws.masks2)
    term2_1 = _sum_entropy_bernoulli(agent.decode(mean_b))
    # Fixed theta, reparameterized sample.
    term2_2 = _sum_entropy_bernoulli(
        agent.decode(reparameterize(ps1_mean, ps1_logvar, eps=draws.eps_fixed)))
    term2 = term2_1 - term2_2

    G = -term0 + term1 + term2
    return G, [term0, term1, term2], ps1_mean, po1


def _rollout(agent, s0, pi, step_draws, calc_mean, samples, mean_estimator):
    """Sum G and terms over the steps; returns (G, terms, last po1)."""
    s = s0
    sum_G, sums, po1 = None, None, None
    for d in step_draws:
        if mean_estimator:
            G, terms, ps1_mean, po1 = calculate_G_mean(agent, s, pi, draws=d)
            s1 = ps1_mean
        else:
            G, terms, s1, ps1_mean, po1 = calculate_G(agent, s, pi, samples, draws=d)
        s = ps1_mean if calc_mean else s1
        if sum_G is None:
            sum_G, sums = G, list(terms)
        else:
            sum_G = sum_G + G
            sums = [a + b for a, b in zip(sums, terms)]
    return sum_G, sums, po1


def _start_state(agent, o, calc_mean, eps0):
    qs0_mean, qs0_logvar = agent.encode(o)
    return qs0_mean if calc_mean else reparameterize(qs0_mean, qs0_logvar, eps=eps0)


def calculate_G_repeated(agent: ActiveInferenceAgent, o: torch.Tensor, pi: torch.Tensor,
                         generator: Optional[torch.Generator] = None, steps: int = 1,
                         calc_mean: bool = False, samples: int = 10,
                         mean_estimator: bool = False,
                         draws: Optional[RolloutDraws] = None):
    """Roll G forward ``steps`` imagination steps under a fixed action,
    summing the terms. ``calc_mean`` feeds the transition mean (not the
    sample) forward; ``mean_estimator`` selects ``calculate_G_mean`` per
    step instead of the sampled ``calculate_G``. o: (B, C, H, W); pi:
    (B, pi_dim). Returns (sum_G, sum_terms, last po1)."""
    B = o.shape[0]
    if draws is None:
        draws = draw_rollout(agent, B, B, generator, o.device, steps, calc_mean,
                             samples, mean_estimator)
    s0 = _start_state(agent, o, calc_mean, draws.eps0)
    return _rollout(agent, s0, pi, draws.steps, calc_mean, samples, mean_estimator)


def calculate_G_4_repeated(agent: ActiveInferenceAgent, o: torch.Tensor,
                           generator: Optional[torch.Generator] = None, steps: int = 1,
                           calc_mean: bool = False, samples: int = 10,
                           draws: Optional[RolloutDraws] = None):
    """G for every action of each observation. Rows are (b, a), action
    fastest; the per-step estimator is ``calculate_G_mean`` when
    ``calc_mean``, else ``calculate_G``. Returns (sum_G, sum_terms, po1)
    with sum_G and terms (B, pi_dim)."""
    B, A = o.shape[0], agent.pi_dim
    if draws is None:
        draws = draw_rollout(agent, B, B * A, generator, o.device, steps, calc_mean,
                             samples, mean_estimator=calc_mean)
    s0 = _start_state(agent, o, calc_mean, draws.eps0)
    s0_r = s0.repeat_interleave(A, dim=0)
    pi_r = agent.pi_one_hot.repeat(B, 1)
    sum_G, sums, po1 = _rollout(agent, s0_r, pi_r, draws.steps, calc_mean, samples,
                                mean_estimator=calc_mean)
    return sum_G.reshape(B, A), [t.reshape(B, A) for t in sums], po1


def calculate_G_4_repeated_crn(agent: ActiveInferenceAgent, o: torch.Tensor,
                               generator: Optional[torch.Generator] = None,
                               steps: int = 1, calc_mean: bool = False,
                               samples: int = 10, mean_estimator: bool = False,
                               draws: Optional[RolloutDraws] = None):
    """All-actions G with common random numbers: every action column reuses
    the same draws, so column a is exactly ``calculate_G_repeated`` with
    pi = a under those draws. Returns (sum_G, sum_terms, po1), G and terms
    (B, pi_dim), po1 in (b, a) row order."""
    B, A = o.shape[0], agent.pi_dim
    if draws is None:
        draws = draw_rollout(agent, B, B, generator, o.device, steps, calc_mean,
                             samples, mean_estimator)
    cols = [
        calculate_G_repeated(agent, o, agent.pi_one_hot[a].expand(B, A), steps=steps,
                             calc_mean=calc_mean, samples=samples,
                             mean_estimator=mean_estimator, draws=draws)
        for a in range(A)
    ]
    G = torch.stack([c[0] for c in cols], dim=1)
    terms = [torch.stack([c[1][i] for c in cols], dim=1) for i in range(3)]
    po1 = torch.stack([c[2] for c in cols], dim=1)
    return G, terms, po1.reshape((B * A,) + tuple(po1.shape[2:]))


def calculate_G_given_trajectory(agent: ActiveInferenceAgent, s0_traj: torch.Tensor,
                                 ps1_traj: torch.Tensor, ps1_mean_traj: torch.Tensor,
                                 ps1_logvar_traj: torch.Tensor, pi0_traj: torch.Tensor,
                                 generator: Optional[torch.Generator] = None,
                                 draws: Optional[TrajectoryDraws] = None) -> torch.Tensor:
    """G of a pre-sampled (s, pi) trajectory, row by row. Every ``*_traj``
    is (N, dim): time and batch may be folded together."""
    if draws is None:
        draws = draw_trajectory(agent, s0_traj.shape[0], generator, s0_traj.device)
    po1 = agent.decode(ps1_traj)
    _, qs1_logvar = agent.encode(po1)
    term0 = agent.check_reward(po1)
    term1 = -_state_entropy(ps1_logvar_traj, qs1_logvar)
    # Fresh theta, decode the transition SAMPLE (calculate_G_mean decodes
    # the mean here).
    ps1_b, _, _ = agent.transition_with_sample(pi0_traj, s0_traj, draws.masks,
                                               eps=draws.eps)
    term2_1 = _sum_entropy_bernoulli(agent.decode(ps1_b))
    term2_2 = _sum_entropy_bernoulli(agent.decode(
        reparameterize(ps1_mean_traj, ps1_logvar_traj, eps=draws.eps_fixed)))
    return -term0 + term1 + (term2_1 - term2_2)


def habit_rollout(agent: ActiveInferenceAgent, starting_s: torch.Tensor,
                  draws: HabitRolloutDraws, use_means: bool = False):
    """Roll the habit policy forward under sampled thetas. Returns the
    depth-major stacks (s0, ps1, ps1_mean, ps1_logvar, pi one-hot), each
    (depth, B, dim), and the habit distribution at the first step (B,
    pi_dim). The sample threads on unless ``use_means``."""
    s_t = starting_s
    steps, q_pi0 = [], None
    for t in range(draws.gumbel.shape[0]):
        _, q_pi, _ = agent.habit(s_t)
        if q_pi0 is None:
            q_pi0 = q_pi
        a = rnd.categorical(torch.log(q_pi + 1e-20), noise=draws.gumbel[t])
        pi_t = agent.pi_one_hot[a]
        ps1, ps1_mean, ps1_logvar = agent.transition_with_sample(
            pi_t, s_t, draws.masks[t], eps=draws.eps[t])
        steps.append((s_t, ps1, ps1_mean, ps1_logvar, pi_t))
        s_t = ps1_mean if use_means else ps1
    return tuple(torch.stack(x) for x in zip(*steps)) + (q_pi0,)


def mcts_step_simulate(agent: ActiveInferenceAgent, starting_s: torch.Tensor, depth: int,
                       use_means: bool = False,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[SimulateDraws] = None):
    """Rollout under the habit policy from leaf states, scored by trajectory G.
    starting_s: (B, s_dim). Returns (G, pi0_traj, Qpi_root): G (B,) the
    mean over depth of the trajectory's rows, pi0_traj (depth, B, pi_dim)
    one-hot, Qpi_root (B, pi_dim) the habit output of the first step."""
    B = starting_s.shape[0]
    if draws is None:
        draws = draw_simulate(agent, B, depth, generator, starting_s.device)
    s0_tr, ps1_tr, mean_tr, logvar_tr, pi_tr, q_pi0 = habit_rollout(
        agent, starting_s, draws.rollout, use_means)
    G_rows = calculate_G_given_trajectory(
        agent, s0_tr.flatten(0, 1), ps1_tr.flatten(0, 1), mean_tr.flatten(0, 1),
        logvar_tr.flatten(0, 1), pi_tr.flatten(0, 1), draws=draws.trajectory)
    return G_rows.reshape(depth, B).mean(dim=0), pi_tr, q_pi0
