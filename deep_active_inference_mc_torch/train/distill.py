"""MCTS-visit distillation into the habitual network (AlphaZero-style).

Port of ``deep_active_inference_mc_tpu/train/distill.py``. A phase has two
stages:

  1. **Collect**: a fleet of ``distill_envs`` fresh envs is driven by the
     batched planner (``plan.mcts.active_inference_mcts``, fused evaluator,
     ``distill_expand_k`` leaves per iteration) for ``distill_macro``
     decisions; every decision records the env latents and last reward
     (the frame re-renders exactly from the LUT, so frames are not stored)
     and the root visit counts.
  2. **Distill**: the records replay through the current encoder and the
     habit net takes top-only Adam steps on ``F_top = KL[Q(pi|s) ||
     visits / sum(visits)]``, the round's ``losses.compute_loss_top`` with
     the sharper target, on the round's own top optimizer.

Only the ``top`` module's weights and its optimizer's state change. The
phase computes in the agent's dtype (``ActiveInferenceAgent(dtype=)``: bf16
forwards under ``--bf16``; the planner scores G in float32). Every
draw can be injected (``CollectDraws``, ``DistillDraws``): the env's
randomize and respawns, the planner's noise, the permutations and the
encoder's noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.plan import mcts as mcts_lib
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.train import losses


def visit_targets(root_N: torch.Tensor, temp: float = 1.0) -> torch.Tensor:
    """Normalized (optionally tempered) root visit distribution: ``temp``
    < 1 sharpens toward the argmax visit, > 1 flattens; 1.0 is the plain
    AlphaZero pi ~ N(s,a)/sum N target."""
    n = torch.clamp(root_N.to(torch.float32), min=0.0)
    if temp != 1.0:
        n = torch.pow(n + 1e-20, 1.0 / temp)
    return n / torch.clamp(torch.sum(n, dim=-1, keepdim=True), min=1e-20)


@dataclasses.dataclass
class CollectDraws:
    """Noise of one collect: the fleet's randomize draws, each decision's
    respawns (repeats, B, 6) and each decision's planner noise
    (``mcts.SearchDraws``; None: the planner seeds decision t with (0, t))."""

    env: env_lib.EnvDraws
    respawns: Sequence[torch.Tensor]
    plans: Optional[Sequence[mcts_lib.SearchDraws]] = None


@dataclasses.dataclass
class StepDraws:
    """Noise of one replay step: the encoder's state draw and, under
    ``vae_train_dropout``, its keep-masks."""

    eps: torch.Tensor
    enc_masks: Optional[Sequence[torch.Tensor]] = None


@dataclasses.dataclass
class DistillDraws:
    """Noise of a whole phase: the collect's, one permutation per pass and
    one StepDraws per replay step."""

    collect: CollectDraws
    perms: Sequence[torch.Tensor]
    steps: Sequence[StepDraws]


class Distiller:
    """One MCTS-visit distillation phase: ``distiller(state, generator)``
    returns the state (``top`` and its optimizer updated in place) and the
    phase's metrics."""

    def __init__(self, agent: ActiveInferenceAgent, cfg: Config, lut: torch.Tensor):
        self.agent = agent
        self.cfg = cfg
        self.lut = lut
        self.n_record = cfg.distill_envs * cfg.distill_macro
        self.mcts_params = mcts_lib.MCTSParams(
            repeats=cfg.distill_repeats, expand_k=cfg.distill_expand_k, fused_eval=True,
            max_depth=16)

    def _render(self, env: env_lib.EnvState) -> torch.Tensor:
        return env_lib.render_obs(self.lut, env, self.cfg.resolution, self.cfg.colour_channels)

    @torch.inference_mode()
    def collect(self, generator: Optional[torch.Generator] = None,
                draws: Optional[CollectDraws] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Drive ``distill_envs`` fresh envs for ``distill_macro`` planner
        decisions; returns the records (latents (n, 6), last_r (n,),
        root visits (n, A)), decision-major."""
        cfg, agent = self.cfg, self.agent
        device = self.lut.device
        if draws is None:
            env = env_lib.randomize(env_lib.reset(generator, cfg.distill_envs, device), generator)
            # The planner's seeds: one per phase from the run's stream, then
            # the decision index.
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=device))
        else:
            env, seed = env_lib.EnvState(*draws.env), 0
        lat, last_r, root_N = [], [], []
        for t in range(cfg.distill_macro):
            o = self._render(env)
            plan_draws = None if draws is None or draws.plans is None else draws.plans[t]
            res = mcts_lib.active_inference_mcts(
                agent, o, self.mcts_params, seed_path=None if plan_draws else (seed, t),
                draws=plan_draws)
            root_best = torch.argmax(res.root_N, dim=-1)
            a = torch.where(res.lengths > 0, res.actions[:, 0], root_best)
            lat.append(env.latents)
            last_r.append(env.last_r)
            root_N.append(res.root_N)
            env, _ = env_lib.step_repeated(
                env, env_lib.to_env_actions(a, agent.pi_dim), cfg.repeats, generator,
                None if draws is None else draws.respawns[t])
        return torch.cat(lat), torch.cat(last_r), torch.cat(root_N)

    def dstep(self, top_opt: torch.optim.Optimizer, latents: torch.Tensor,
              last_r: torch.Tensor, log_target: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              draws: Optional[StepDraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One top-only Adam step on a replayed minibatch: re-render the
        recorded latents (K1 on a card), encode with a sample (the
        encoder's dropout as ``vae_train_dropout``), F_top against the
        visit targets. Returns (F, argmax match), 0-d tensors."""
        agent = self.agent
        rows = latents.shape[0]
        env = env_lib.EnvState(latents, torch.zeros_like(last_r), last_r)
        o = self._render(env)
        with torch.no_grad():
            masks = eps = None
            if draws is not None:
                eps, masks = draws.eps, draws.enc_masks
            if self.cfg.vae_train_dropout and masks is None:
                masks = agent.down.encoder.draw_masks(rows, generator, o.device)
            qs0, _, _ = agent.encode_with_sample(
                o, generator, eps, masks if self.cfg.vae_train_dropout else None)
        F_top, (_, _, q_pi) = losses.compute_loss_top(agent, qs0, log_target)
        F = F_top.mean()
        train_loop._step(top_opt, F, self.cfg.clip_grad)
        with torch.no_grad():
            match = (torch.argmax(q_pi, -1) == torch.argmax(log_target, -1)).float().mean()
        return F.detach(), match

    def __call__(self, state: train_loop.TrainState,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[DistillDraws] = None
                 ) -> Tuple[train_loop.TrainState, Dict[str, float]]:
        cfg = self.cfg
        n = self.n_record
        bs = min(cfg.distill_batch, n)
        steps_per_pass = n // bs
        if cfg.distill_passes < 1 or steps_per_pass < 1:
            raise ValueError(
                f"distill phase would take 0 steps (passes={cfg.distill_passes}, "
                f"records={n}, batch={bs})")
        lat, lr, root_N = self.collect(generator, None if draws is None else draws.collect)
        # Inference tensors cannot be saved for backward: the replay takes
        # plain copies.
        lat, lr, root_N = lat.clone(), lr.clone(), root_N.clone()
        target = visit_targets(root_N, cfg.distill_temp)
        log_target = torch.log(target + 1e-20)
        # Teacher sharpness diagnostic: mean entropy of the visit targets.
        ent = torch.mean(-torch.sum(target * log_target, dim=-1))

        top_opt = state.opts["top"]
        F_match: List[torch.Tensor] = []
        step = 0
        for p in range(cfg.distill_passes):
            perm = (torch.randperm(n, generator=generator, device=lat.device)
                    if draws is None else draws.perms[p])
            for i in range(steps_per_pass):
                idx = perm[i * bs:(i + 1) * bs]
                F, match = self.dstep(top_opt, lat[idx], lr[idx], log_target[idx], generator,
                                      None if draws is None else draws.steps[step])
                if step == 0:
                    F_match.append(torch.stack([F, match]))
                step += 1
        F_match.append(torch.stack([F, match]))
        (F_first, match_first), (F_last, match_last) = torch.stack(F_match).tolist()
        metrics = {
            "distill_kl_first": F_first,
            "distill_kl_last": F_last,
            "distill_match_first": match_first,
            "distill_match_last": match_last,
            "distill_target_entropy": float(ent),
            "distill_steps": float(step),
        }
        return state, metrics
