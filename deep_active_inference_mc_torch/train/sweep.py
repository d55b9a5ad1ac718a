"""Batched policy evaluation: score a controller over vectorized envs.

Port of ``deep_active_inference_mc_tpu/train/sweep.py`` (``make_sweep``,
``run_sweep``, ``_run_macro_chunks``). Each macro step renders every env
(kernel K1 on a card), picks one action per env, and executes it
``jumps`` times with the scoring-abort rule. Controllers:

  ai      softmax(-G/T) over the 4 single-step EFE estimates
  t1      reward-term-only agent
  t12     terms a+b agent
  habit   habitual network
  random  uniform actions (baseline)
  expert  ground-truth policy (upper bound)

``plan_queue`` runs ai/t1/t12 under the reference demo's plan-execution
protocol: the sampled action is enqueued ``steps`` macro steps deep (at
most ``queue_cap`` when set), one entry executes per macro step, and a
scoring event flushes the queue. Planning still runs every macro step for
the whole batch; only envs whose queue ran out adopt the new plan.

Randomness: one ``torch.Generator`` per macro chunk, seeded from
``(seed, 1, chunk)`` (``(seed, 1, 10000 + group, chunk)`` per env group),
and one seeded from ``(seed, 0)`` for the initial envs. Everything runs
under ``torch.inference_mode()``; the host syncs once per chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.utils import random as rnd
from deep_active_inference_mc_torch.utils.device import seeded_generator

METHODS = ("ai", "t1", "t12", "habit", "random", "expert")
QUEUE_METHODS = ("ai", "t1", "t12")
_ENV_STREAM, _RUN_STREAM = 0, 1


@dataclasses.dataclass
class MacroDraws:
    """Noise of one macro step, for injection: the Gumbel noise of the
    action draw (B, pi_dim), the respawn latents of each repeat
    (jumps, B, 6) and, for ai/t1/t12, the G rollout's draws."""

    gumbel: torch.Tensor
    respawns: torch.Tensor
    rollout: Optional[efe.RolloutDraws] = None


def _efe_score(agent, generator, o, method, steps, samples, calc_mean, crn,
               g_draws=None):
    """(B, pi_dim) score whose softmax is the ai/t1/t12 action prior."""
    if crn:
        G, terms, _ = efe.calculate_G_4_repeated_crn(
            agent, o, generator, steps=steps, calc_mean=calc_mean,
            samples=samples, mean_estimator=calc_mean, draws=g_draws,
        )
    else:
        G, terms, _ = efe.calculate_G_4_repeated(
            agent, o, generator, steps=steps, calc_mean=calc_mean, samples=samples,
            draws=g_draws,
        )
    t0 = -terms[0]
    t1 = terms[1]
    if method == "ai":
        return -G
    if method == "t1":
        return -t0
    return -(t0 + t1)


def _controller_actions(agent, generator, o, env, method, steps, samples,
                        temperature, calc_mean, crn=False, draws=None):
    """One decision per env: (B,) actions in agent space (env space for
    the expert). Every controller samples by Gumbel-max; the random
    baseline over equal logits."""
    if method == "random":
        logits = torch.zeros((env.batch, agent.pi_dim), device=env.device)
    elif method == "expert":
        logits = torch.log(env_lib.expert_policy(env) + 1e-20)
    elif method == "habit":
        logits = torch.log(agent.habitual_net(o) + 1e-20)
    else:
        score = _efe_score(agent, generator, o, method, steps, samples, calc_mean,
                           crn, None if draws is None else draws.rollout)
        logits = score / temperature
    return rnd.categorical(logits, generator, None if draws is None else draws.gumbel)


def _render_fn(lut, resolution: int, channels: int):
    if resolution != 64 or channels != 1:
        return lambda env: env_lib.render_obs(lut, env, resolution, channels)
    return lambda env: env_lib.render(lut, env)


def make_sweep(
    agent: ActiveInferenceAgent,
    cfg: Config,
    lut: torch.Tensor,
    method: str = "ai",
    n_macro_steps: int = 100,
    steps: int = 1,
    samples: int = 1,
    jumps: int = 5,
    temperature: float = 1.0,
    calc_mean: bool = True,
    zero_score: bool = True,
    crn: bool = False,
    plan_queue: bool = False,
    queue_cap: int = 0,
):
    """A sweep: ``run(generator, env, qstate=None)`` -> score stats.

    ``zero_score=False`` continues a prior chunk's score. calc_mean=True
    is the reference demo's ``--mean`` evaluation mode; calc_mean=False
    with samples=10 is its sampling default. With ``plan_queue`` (ai/t1/
    t12) the result carries ``"qstate"`` = (queue, qlen, qpos) for the
    next chunk."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    use_queue = plan_queue and method in QUEUE_METHODS
    q_cap = max(steps, 1)
    if queue_cap:
        q_cap = min(q_cap, queue_cap)
    render_fn = _render_fn(lut, cfg.resolution, cfg.colour_channels)

    def macro_step(generator, env, a, respawns=None):
        # The expert acts in env space; agent controllers (and the random
        # baseline) act in agent space.
        if method != "expert":
            a = env_lib.to_env_actions(a, agent.pi_dim)
        # The shape at macro start is the shape that scores this macro:
        # a respawn freezes the env for the rest of the macro.
        is_sq = env.latents[..., 1] == 0
        score0 = env.score
        env, scored = env_lib.step_repeated(env, a, jumps, generator, respawns)
        delta = env.score - score0
        tallies = torch.stack([
            scored.sum().to(torch.float32),
            (scored & is_sq).sum().to(torch.float32),
            (scored & ~is_sq).sum().to(torch.float32),
            torch.where(is_sq, delta, 0.0).sum(),
            torch.where(~is_sq, delta, 0.0).sum(),
        ])
        return env, scored, tallies

    def init_qstate(n_envs: int, device):
        z = lambda *shape: torch.zeros(shape, dtype=torch.long, device=device)
        return z(n_envs, q_cap), z(n_envs), z(n_envs)

    @torch.inference_mode()
    def run(generator: Optional[torch.Generator], env: env_lib.EnvState,
            qstate=None, draws: Optional[Sequence[MacroDraws]] = None):
        """``draws`` (one MacroDraws per macro step) replaces the generator."""
        if zero_score:
            env = env.replace(score=torch.zeros_like(env.score))
        if use_queue and qstate is None:
            qstate = init_qstate(env.batch, env.device)
        rows = []
        for t in range(n_macro_steps):
            d = None if draws is None else draws[t]
            o = render_fn(env)
            a = _controller_actions(agent, generator, o, env, method, steps,
                                    samples, temperature, calc_mean, crn, d)
            respawns = None if d is None else d.respawns
            if use_queue:
                queue, qlen, qpos = qstate
                need = qpos >= qlen
                queue = torch.where(need[:, None], a[:, None], queue)
                qlen = torch.where(need, min(steps, q_cap), qlen)
                qpos = torch.where(need, 0, qpos)
                a = torch.gather(queue, 1, qpos[:, None])[:, 0]
                qpos = qpos + 1
                env, scored, tallies = macro_step(generator, env, a, respawns)
                # Scoring flushes the queue: the plan addressed the
                # now-respawned object.
                qstate = (queue, qlen, torch.where(scored, qlen, qpos))
            else:
                env, _, tallies = macro_step(generator, env, a, respawns)
            rows.append(tallies)
        tallies = torch.stack(rows).cpu()  # the chunk's one host sync
        ev_all, ev_sq, ev_oth, r_sq, r_oth = tallies.unbind(1)
        out = _score_stats(env.score)
        n = env.batch
        out.update({
            "scoring_events": float(ev_all.sum()),
            "events_sq": float(ev_sq.sum()),
            "events_other": float(ev_oth.sum()),
            "score_sq": float(r_sq.sum()) / n,
            "score_other": float(r_oth.sum()) / n,
            "env": env,
        })
        if use_queue:
            out["qstate"] = qstate
        return out

    return run


def _score_stats(scores: torch.Tensor) -> Dict:
    n = scores.shape[0]
    s = scores.double().cpu()
    std = float(s.std(correction=0))
    return {
        "score_mean": float(s.mean()),
        "score_std": std,
        "score_min": float(s.min()),
        "score_max": float(s.max()),
        "score_sem": std / n ** 0.5,
        "scores": scores,
    }


_ACC_KEYS = ("scoring_events", "events_sq", "events_other", "score_sq", "score_other")


def _run_macro_chunks(sweeps, path, env, lengths):
    """Drive one env batch through the macro chunks; chunk i draws from a
    generator seeded from ``path + (i,)``."""
    acc = {k: 0.0 for k in _ACC_KEYS}
    out = None
    qstate = None
    for i, n in enumerate(lengths):
        out = sweeps[n](seeded_generator(env.device, *path, i), env, qstate)
        env = out["env"]
        qstate = out.get("qstate")
        for k in _ACC_KEYS:
            acc[k] += out[k]
    out = dict(out)
    out.update(acc)
    return out


def run_sweep(
    agent: ActiveInferenceAgent,
    cfg: Config,
    lut: torch.Tensor,
    seed: int = 0,
    n_envs: int = 1024,
    n_macro_steps: int = 100,
    chunk: int = 50,
    env_chunk: Optional[int] = None,
    **kwargs,
) -> Dict:
    """Evaluate over ``n_envs`` fresh environments on ``lut``'s device.

    Runs ceil(n_macro_steps/chunk) chunks with the env carried across.
    ``env_chunk`` bounds the env-batch width: the full batch is made once
    (so initial states pair with an unchunked run at the same seed), then
    evaluated as independent groups of env_chunk envs; scores are exact
    per group, only the groups' random streams differ."""
    device = lut.device
    g_env = seeded_generator(device, seed, _ENV_STREAM)
    env = env_lib.randomize(env_lib.reset(g_env, n_envs, device), g_env)
    chunk = min(chunk, n_macro_steps)
    lengths = [chunk] * (n_macro_steps // chunk)
    if n_macro_steps % chunk:
        lengths.append(n_macro_steps % chunk)
    sweeps = {
        n: make_sweep(agent, cfg, lut, n_macro_steps=n, zero_score=False, **kwargs)
        for n in set(lengths)
    }
    env = env.replace(score=torch.zeros_like(env.score))
    if not env_chunk or env_chunk >= n_envs:
        return _run_macro_chunks(sweeps, (seed, _RUN_STREAM), env, lengths)
    if env_chunk < 0:
        raise ValueError(f"env_chunk={env_chunk} must be positive")
    if n_envs % env_chunk:
        raise ValueError(f"env_chunk={env_chunk} must divide n_envs={n_envs}")
    outs = [
        _run_macro_chunks(
            sweeps, (seed, _RUN_STREAM, 10_000 + g),
            env.select(slice(g * env_chunk, (g + 1) * env_chunk)), lengths,
        )
        for g in range(n_envs // env_chunk)
    ]
    scores = torch.cat([o["scores"] for o in outs])
    merged = _score_stats(scores)
    merged["env"] = env_lib.EnvState(
        *(torch.cat([getattr(o["env"], f) for o in outs])
          for f in ("latents", "score", "last_r"))
    )
    for k in _ACC_KEYS:
        vals = [o[k] for o in outs]
        # score_sq/score_other are per-env means over equal-sized groups.
        merged[k] = sum(vals) / len(vals) if k.startswith("score") else sum(vals)
    return merged
