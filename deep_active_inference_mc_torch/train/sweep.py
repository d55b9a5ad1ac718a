"""Batched policy evaluation: score a controller over vectorized envs.

Port of ``deep_active_inference_mc_tpu/train/sweep.py`` (``make_sweep``,
``run_sweep``, ``_run_macro_chunks``, ``run_sweep_bucketed``). Each macro
step renders every env (kernel K1 on a card), picks one action per env,
and executes it ``jumps`` times with the scoring-abort rule. Controllers:

  ai      softmax(-G/T) over the 4 single-step EFE estimates
  t1      reward-term-only agent
  t12     terms a+b agent
  habit   habitual network
  mcts    batched array-MCTS, first action of the planned path
  random  uniform actions (baseline)
  expert  ground-truth policy (upper bound)

``plan_queue`` runs mcts/ai/t1/t12 under the reference demo's
plan-execution protocol: the whole trimmed MCTS path (or the EFE agent's
sampled action ``steps`` deep) is enqueued, at most ``queue_cap`` entries
when set, one entry executes per macro step, and a scoring event flushes
the queue. In ``make_sweep`` planning still runs every macro step for the
whole batch and only envs whose queue ran out adopt the new plan;
``run_sweep_bucketed`` plans only for those envs.

Randomness: one ``torch.Generator`` per macro chunk, seeded from
``(seed, 1, chunk)`` (``(seed, 1, 10000 + group, chunk)`` per env group),
and one seeded from ``(seed, 0)`` for the initial envs. The planner of
macro step ``t`` of a chunk is seeded from that generator's seed and ``t``.
Everything runs under ``torch.inference_mode()``; ``make_sweep``'s host
syncs once per chunk (and, under mcts, where the planner reads its done
flag). On a card a chunk of every method but mcts is the counterpart of
the JAX package's jitted scan: one captured CUDA graph of a macro step,
replayed per macro step, its noise drawn eagerly with ``draw_macro`` (the
order the eager step draws it), so it scores what the eager chunk scores.
Under mcts the macro steps run op by op (a graph of one could not hold
the search's loop of unknown length), and the planner, built once per
sweep (``plan.mcts.make_jit_planner``; ``make_bucketed_planner`` for
``run_sweep_bucketed``), replays its own graph of one search iteration.

``mesh`` (``parallel/mesh.py``, data ranks only) shards the envs over the
ranks, the counterpart of ``run_sweep(..., mesh=)``: every rank draws each
macro step's noise for the global batch (``draw_macro``, in the order the
unsharded step draws it) and keeps its rows, so ``ai``, ``t1``, ``t12``,
``habit``, ``random`` and ``expert`` score what the single-rank sweep scores
at the same seed. The score statistics and tallies are taken over all
envs (one all-reduce per chunk). ``mcts`` plans each rank's shard with the
search seeded by the macro step and the rank, so its scores are a sample
of the same distribution, not the single-rank sweep's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
from deep_active_inference_mc_torch.plan import mcts as mcts_lib
from deep_active_inference_mc_torch.utils import graphs as graphs_lib
from deep_active_inference_mc_torch.utils import profiling
from deep_active_inference_mc_torch.utils import random as rnd
from deep_active_inference_mc_torch.utils.device import seeded_generator

METHODS = ("ai", "t1", "t12", "habit", "mcts", "random", "expert")
QUEUE_METHODS = ("mcts", "ai", "t1", "t12")
_ENV_STREAM, _RUN_STREAM, _PLAN_STREAM = 0, 1, 2


@dataclasses.dataclass
class MacroDraws:
    """Noise of one macro step, for injection: the Gumbel noise of the
    action draw (B, pi_dim), the respawn latents of each repeat
    (jumps, B, 6) and, for ai/t1/t12, the G rollout's draws; for mcts the
    search's (and no Gumbel noise: the planner's action is not sampled)."""

    gumbel: Optional[torch.Tensor]
    respawns: torch.Tensor
    rollout: Optional[efe.RolloutDraws] = None
    search: Optional[mcts_lib.SearchDraws] = None


def draw_macro(agent, method: str, batch: int, generator: torch.Generator, device,
               steps: int = 1, samples: int = 1, calc_mean: bool = True, crn: bool = False,
               jumps: int = 5) -> MacroDraws:
    """One macro step's noise over ``batch`` envs, drawn in the order the
    step draws it from ``generator``: the G rollout (ai/t1/t12), the Gumbel
    noise of the action (all but mcts), the respawns."""
    rollout = None
    if method in ("ai", "t1", "t12"):
        rows = batch if crn else batch * agent.pi_dim
        rollout = efe.draw_rollout(agent, batch, rows, generator, device, steps, calc_mean,
                                   samples, mean_estimator=calc_mean)
    width = 4 if method == "expert" else agent.pi_dim  # the expert acts in env space
    gumbel = None if method == "mcts" else rnd.gumbel((batch, width), generator, device)
    respawns = env_lib.sample_latents(generator, (jumps, batch), device)
    return MacroDraws(gumbel, respawns, rollout)


def shard_macro_draws(d: MacroDraws, batch: int, mesh: mesh_lib.Mesh, pi_dim: int,
                      crn: bool = False) -> MacroDraws:
    """This data rank's rows of a ``batch``-env macro step's draws."""
    rows = mesh.data_slice(batch)
    take = lambda t, inner=1: mesh_lib.take_rows(t, rows, batch, inner)
    rollout = d.rollout and efe.RolloutDraws(take(d.rollout.eps0),
                                             take(d.rollout.steps, 1 if crn else pi_dim))
    return MacroDraws(take(d.gumbel), d.respawns[:, rows], rollout, d.search)


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


def _mcts_plan(agent, o, planner, seed_path, draws):
    """``planner``'s (``make_jit_planner``'s plan) trimmed path with the
    visit-max root action in place of an empty one (the demo would simply
    re-plan next frame): ((B, max_depth) actions, (B,) lengths >= 1)."""
    res = planner(o, seed_path, draws=None if draws is None else draws.search)
    actions = res.actions.clone()
    actions[:, 0] = torch.where(res.lengths > 0, actions[:, 0],
                                torch.argmax(res.root_N, dim=-1))
    return actions, torch.clamp(res.lengths, min=1)


def _controller_actions(agent, generator, o, env, method, steps, samples,
                        temperature, planner, calc_mean, crn=False, draws=None,
                        seed_path=None, g_events=None):
    """One decision per env: (B,) actions in agent space (env space for
    the expert). mcts takes the first action of ``planner``'s plan; every
    other controller samples by Gumbel-max, the random baseline over equal
    logits. ``g_events``: a pair of timing events recorded around G while
    a graph captures the step."""
    if method == "mcts":
        return _mcts_plan(agent, o, planner, seed_path, draws)[0][:, 0]
    if method == "random":
        logits = torch.zeros((env.batch, agent.pi_dim), device=env.device)
    elif method == "expert":
        logits = torch.log(env_lib.expert_policy(env) + 1e-20)
    elif method == "habit":
        logits = torch.log(agent.habitual_net(o) + 1e-20)
    else:
        timed = g_events is not None and torch.cuda.is_current_stream_capturing()
        if timed:
            g_events[0].record()
        score = _efe_score(agent, generator, o, method, steps, samples, calc_mean,
                           crn, None if draws is None else draws.rollout)
        if timed:
            g_events[1].record()
        logits = score / temperature
    return rnd.categorical(logits, generator, None if draws is None else draws.gumbel)


def _controller_plan(agent, generator, o, env, method, steps, samples, temperature,
                     planner, calc_mean, crn=False, draws=None, seed_path=None,
                     g_events=None):
    """One decision per env as a plan: ((B, width) actions, (B,) lengths).
    mcts: ``planner``'s trimmed visit-max path. ai/t1/t12: the sampled
    action ``steps`` wide."""
    if method == "mcts":
        return _mcts_plan(agent, o, planner, seed_path, draws)
    a = _controller_actions(agent, generator, o, env, method, steps, samples,
                            temperature, planner, calc_mean, crn, draws, g_events=g_events)
    return a[:, None].expand(-1, max(steps, 1)), torch.full_like(a, steps)


def _render_fn(lut, resolution: int, channels: int):
    if resolution != 64 or channels != 1:
        return lambda env: env_lib.render_obs(lut, env, resolution, channels)
    return lambda env: env_lib.render(lut, env)


def _step_and_tally(env, a_env, jumps: int, generator, respawns=None):
    """Execute env-space actions ``jumps`` times: (env, scored, tallies).
    Tallies: scoring events (all, squares, others), the score gained on
    squares and on others, and the fleet-mean cumulative score after."""
    # The shape at macro start is the shape that scores this macro: a
    # respawn freezes the env for the rest of the macro.
    is_sq = env.latents[..., 1] == 0
    score0 = env.score
    env, scored = env_lib.step_repeated(env, a_env, jumps, generator, respawns)
    delta = env.score - score0
    tallies = torch.stack([
        scored.sum().to(torch.float32),
        (scored & is_sq).sum().to(torch.float32),
        (scored & ~is_sq).sum().to(torch.float32),
        torch.where(is_sq, delta, 0.0).sum(),
        torch.where(~is_sq, delta, 0.0).sum(),
        env.score.mean(),
    ])
    return env, scored, tallies


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
    mcts_params: Optional[mcts_lib.MCTSParams] = None,
    calc_mean: bool = True,
    zero_score: bool = True,
    crn: bool = False,
    record_traj: bool = False,
    plan_queue: bool = False,
    queue_cap: int = 0,
    mesh: Optional[mesh_lib.Mesh] = None,
    graphed: Optional[bool] = None,
):
    """A sweep: ``run(generator, env, qstate=None)`` -> score stats.

    ``zero_score=False`` continues a prior chunk's score. calc_mean=True
    is the reference demo's ``--mean`` evaluation mode; calc_mean=False
    with samples=10 is its sampling default. With ``plan_queue`` (mcts/ai/
    t1/t12) the result carries ``"qstate"`` = (queue, qlen, qpos) for the
    next chunk. ``record_traj`` adds ``"score_traj"``, the fleet-mean
    score after each macro step.

    ``graphed`` (default: on a card, without a mesh, for every method but
    mcts) replays one captured macro step per macro step
    (``utils/graphs.py``), its noise drawn eagerly with ``draw_macro`` into
    the graph's static buffers and its tallies written into a static
    (n_macro_steps, 6) table; False runs op by op. A graphed sweep on the
    CPU raises, and so does one under a mesh or for mcts. Under mcts the
    macro steps run op by op and the planner (``make_jit_planner``) replays
    its search iteration as a graph on a card without a mesh, unless
    ``graphed`` is False; ``run.planner`` is that planner (None for the
    other methods).

    Spans (``utils/profiling.py``): a call of ``run`` is ``sweep.run``, each
    macro step's draws from the generator ``sweep.draws``, the chunk's host
    sync ``sweep.readback``. A graphed ``ai``, ``t1`` or ``t12`` sweep times
    G inside its graph with a pair of CUDA events and, after each chunk
    with a replay, keeps the last replay's time as ``efe.device``; after
    the sync the planner's pending ``mcts.device`` settles."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if mcts_params is None:
        mcts_params = mcts_lib.MCTSParams(repeats=50, max_depth=16)
    planner_graphed = graphed  # the caller's, before the macro steps' default
    if graphed is None:
        graphed = method != "mcts" and mesh is None and lut.is_cuda
    if graphed and (mesh is not None or method == "mcts"):
        raise ValueError("a graphed sweep runs on one rank and not for mcts (a macro step's "
                         "graph cannot hold the search's loop; the planner replays its own)")
    use_queue = plan_queue and method in QUEUE_METHODS
    # queue_cap > 0 bounds commitment: how much of each plan executes
    # before re-planning (1: re-plan every macro step; 0: the whole plan).
    q_cap = mcts_params.max_depth if method == "mcts" else max(steps, 1)
    if queue_cap:
        q_cap = min(q_cap, queue_cap)
    render_fn = _render_fn(lut, cfg.resolution, cfg.colour_channels)
    graphs = graphs_lib.Graphs()
    spanned_draw = profiling.spanned("sweep.draws")(draw_macro)
    g_events = None
    if graphed and lut.is_cuda and method in ("ai", "t1", "t12"):
        g_events = (torch.cuda.Event(enable_timing=True, external=True),
                    torch.cuda.Event(enable_timing=True, external=True))
    planner = None
    if method == "mcts":  # gloo cannot be captured: a mesh's planner runs op by op
        planner = mcts_lib.make_jit_planner(
            agent, mcts_params,
            graphed=False if mesh is not None or planner_graphed is False else None)

    def macro_step(carry, d, generator=None, seed_path=None):
        """One macro step: ((env, qstate), tallies). ``d`` (None: drawn
        from ``generator``) is this rank's MacroDraws."""
        env, qstate = carry
        o = render_fn(env)
        decision = (agent, generator, o, env, method, steps, samples, temperature,
                    planner, calc_mean, crn, d, seed_path)
        respawns = None if d is None else d.respawns
        if use_queue:
            new_q, new_len = _controller_plan(*decision, g_events=g_events)
            queue, qlen, qpos = qstate
            need = qpos >= qlen
            queue = torch.where(need[:, None], new_q[:, :q_cap], queue)
            qlen = torch.where(need, torch.clamp(new_len, max=q_cap), qlen)
            qpos = torch.where(need, 0, qpos)
            a = torch.gather(queue, 1, qpos[:, None])[:, 0]
            qpos = qpos + 1
        else:
            a = _controller_actions(*decision, g_events=g_events)
        # The expert acts in env space; agent controllers (and the random
        # baseline) act in agent space.
        if method != "expert":
            a = env_lib.to_env_actions(a, agent.pi_dim)
        env, scored, tallies = _step_and_tally(env, a, jumps, generator, respawns)
        if use_queue:
            # Scoring flushes the queue: the plan addressed the
            # now-respawned object.
            qstate = (queue, qlen, torch.where(scored, qlen, qpos))
        return (env, qstate), tallies

    def init_qstate(n_envs: int, device):
        z = lambda *shape: torch.zeros(shape, dtype=torch.long, device=device)
        return z(n_envs, q_cap), z(n_envs), z(n_envs)

    @torch.inference_mode()
    @profiling.spanned("sweep.run")
    def run(generator: Optional[torch.Generator], env: env_lib.EnvState,
            qstate=None, draws: Optional[Sequence[MacroDraws]] = None):
        """``draws`` (one MacroDraws per macro step) replaces the generator.
        Under a mesh ``env`` is this rank's shard, and ``draws`` (drawn
        here unless given) are the global batch's."""
        if zero_score:
            env = env.replace(score=torch.zeros_like(env.score))
        if use_queue and qstate is None:
            qstate = init_qstate(env.batch, env.device)
        n_total = env.batch * (mesh.n_data if mesh else 1)
        draw = lambda: spanned_draw(agent, method, n_total, generator, env.device, steps,
                                    samples, calc_mean, crn, jumps)
        replays = graphs.replays
        if graphed:
            xs = iter(draws) if draws is not None else (draw() for _ in range(n_macro_steps))
            (env, qstate), tallies = graphs.scan(
                macro_step, (env, qstate), xs, n_macro_steps,
                deps=lambda: graphs_lib.module_deps(agent) + [lut])
        else:
            rows = []
            for t in range(n_macro_steps):
                d = None if draws is None else draws[t]
                if mesh is not None:
                    d = shard_macro_draws(d or draw(), n_total, mesh, agent.pi_dim, crn)
                # The planner's seeds: this chunk's seed and the macro step
                # (and the rank, under a mesh).
                seed_path = None if generator is None else (generator.initial_seed(), t)
                if seed_path and mesh is not None and mesh.world > 1:
                    seed_path += (mesh.rank,)
                (env, qstate), tally = macro_step((env, qstate), d, generator, seed_path)
                rows.append(tally)
            tallies = torch.stack(rows)
        scores = env.score
        if mesh is not None:  # sums over all envs; the fleet-mean score too
            tallies[:, 5] *= env.batch
            tallies = mesh.sum_data_(tallies)
            tallies[:, 5] /= n_total
            scores = mesh.gather_data(scores)
        with profiling.span("sweep.readback"):
            tallies = tallies.cpu()  # the chunk's one host sync
            ev_all, ev_sq, ev_oth, r_sq, r_oth, score_t = tallies.unbind(1)
            out = _score_stats(scores)
            n = n_total
            out.update({
                "scoring_events": float(ev_all.sum()),
                "events_sq": float(ev_sq.sum()),
                "events_other": float(ev_oth.sum()),
                "score_sq": float(r_sq.sum()) / n,
                "score_other": float(r_oth.sum()) / n,
                "env": env,
            })
        if g_events is not None and graphs.replays > replays:  # the device is idle here
            profiling.record_device("efe.device", g_events[0].elapsed_time(g_events[1]) / 1e3)
        profiling.settle()  # the planner's mcts.device
        if record_traj:
            out["score_traj"] = score_t
        if use_queue:
            out["qstate"] = qstate
        return out

    run.planner = planner
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
    trajs = []
    out = None
    qstate = None
    for i, n in enumerate(lengths):
        out = sweeps[n](seeded_generator(env.device, *path, i), env, qstate)
        env = out["env"]
        qstate = out.get("qstate")
        for k in _ACC_KEYS:
            acc[k] += out[k]
        if "score_traj" in out:
            trajs.append(out["score_traj"])
    out = dict(out)
    out.update(acc)
    if trajs:
        out["score_traj"] = torch.cat(trajs)
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
    mesh: Optional[mesh_lib.Mesh] = None,
    **kwargs,
) -> Dict:
    """Evaluate over ``n_envs`` fresh environments on ``lut``'s device.

    Runs ceil(n_macro_steps/chunk) chunks with the env carried across.
    ``env_chunk`` bounds the env-batch width: the full batch is made once
    (so initial states pair with an unchunked run at the same seed), then
    evaluated as independent groups of env_chunk envs; scores are exact
    per group, only the groups' random streams differ. ``mesh`` shards each
    group over the data ranks again; ``"scores"`` are then every env's and
    ``"env"`` this rank's."""
    device = lut.device
    g_env = seeded_generator(device, seed, _ENV_STREAM)
    env = env_lib.randomize(env_lib.reset(g_env, n_envs, device), g_env)
    chunk = min(chunk, n_macro_steps)
    lengths = [chunk] * (n_macro_steps // chunk)
    if n_macro_steps % chunk:
        lengths.append(n_macro_steps % chunk)
    sweeps = {
        n: make_sweep(agent, cfg, lut, n_macro_steps=n, zero_score=False, mesh=mesh, **kwargs)
        for n in set(lengths)
    }
    env = env.replace(score=torch.zeros_like(env.score))
    local = (lambda e: e) if mesh is None else (lambda e: e.select(mesh.data_slice(e.batch)))
    if mesh is not None and (env_chunk or n_envs) % mesh.n_data:
        raise ValueError(f"{env_chunk or n_envs} envs per group not divisible by "
                         f"{mesh.n_data} data ranks")
    if not env_chunk or env_chunk >= n_envs:
        return _run_macro_chunks(sweeps, (seed, _RUN_STREAM), local(env), lengths)
    if env_chunk < 0:
        raise ValueError(f"env_chunk={env_chunk} must be positive")
    if n_envs % env_chunk:
        raise ValueError(f"env_chunk={env_chunk} must divide n_envs={n_envs}")
    outs = [
        _run_macro_chunks(
            sweeps, (seed, _RUN_STREAM, 10_000 + g),
            local(env.select(slice(g * env_chunk, (g + 1) * env_chunk))), lengths,
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
    if "score_traj" in outs[0]:
        # Equal-sized groups: the fleet-mean trajectory is the mean of theirs.
        merged["score_traj"] = torch.stack([o["score_traj"] for o in outs]).mean(dim=0)
    return merged


@torch.inference_mode()
def run_sweep_bucketed(
    agent: ActiveInferenceAgent,
    cfg: Config,
    lut: torch.Tensor,
    seed: int = 0,
    n_envs: int = 256,
    n_macro_steps: int = 100,
    jumps: int = 5,
    mcts_params: Optional[mcts_lib.MCTSParams] = None,
    check_every: int = 16,
    min_bucket: int = 32,
    plan_queue: bool = False,
    queue_cap: int = 0,
    graphed: Optional[bool] = None,
) -> Dict:
    """MCTS sweep on the bucketed (batch-compaction) planner.

    The planner is host-driven (``mcts_lib.make_bucketed_planner``), so the
    macro loop runs at host level, with a host sync per macro step. Output
    keys match ``run_sweep``, plus ``"bucket_traces"``: each plan's bucket
    sizes. ``graphed`` as the planner's: each chunk of its search replays a
    captured iteration on a card unless False.

    ``plan_queue`` runs the full-plan protocol with a host-side queue, and
    plans (and renders) only for the envs whose queue ran out, gathered and
    padded to a power-of-two bucket: commitment here cuts planning time by
    the mean plan length."""
    if mcts_params is None:
        mcts_params = mcts_lib.MCTSParams(repeats=50, max_depth=16)
    plan = mcts_lib.make_bucketed_planner(agent, mcts_params, check_every=check_every,
                                          min_bucket=min_bucket, graphed=graphed)
    render_fn = _render_fn(lut, cfg.resolution, cfg.colour_channels)
    device = lut.device

    def apply_actions(generator, env, a):
        a_env = env_lib.to_env_actions(torch.as_tensor(a, device=device), agent.pi_dim)
        return _step_and_tally(env, a_env, jumps, generator)

    def plan_actions(res, m):
        """Host copies of the first ``m`` plans, an empty one replaced by
        the visit-max root action: ((m, max_depth) actions, (m,) lengths)."""
        actions = res.actions[:m].cpu().numpy()
        lengths = res.lengths[:m].cpu().numpy()
        root_best = res.root_N[:m].cpu().numpy().argmax(-1)
        empty = lengths <= 0
        actions[empty, 0] = root_best[empty]
        return actions, np.maximum(lengths, 1)

    g_env = seeded_generator(device, seed, _ENV_STREAM)
    env = env_lib.randomize(env_lib.reset(g_env, n_envs, device), g_env)
    env = env.replace(score=torch.zeros_like(env.score))
    acc = np.zeros(5)
    buckets = []
    queue = np.zeros((n_envs, mcts_params.max_depth), np.int64)
    qlen = np.zeros(n_envs, np.int64)
    qpos = np.zeros(n_envs, np.int64)
    for i in range(n_macro_steps):
        g_step = seeded_generator(device, seed, _RUN_STREAM, i)
        plan_seed = (seed, _PLAN_STREAM, i)
        if plan_queue:
            need = np.nonzero(qpos >= qlen)[0]
            if need.size:
                # The needing envs' frames, padded to a power-of-two bucket
                # (planner rows are independent; pad rows are discarded).
                pad = max(min_bucket, 1 << max(int(need.size) - 1, 0).bit_length())
                sel = np.concatenate([need, np.repeat(need[:1], pad - need.size)])
                o = render_fn(env).index_select(0, torch.as_tensor(sel, device=device))
                res = plan(o, plan_seed)
                buckets.append(plan.bucket_trace)
                actions, lengths = plan_actions(res, need.size)
                queue[need] = actions
                qlen[need] = np.minimum(lengths, queue_cap) if queue_cap else lengths
                qpos[need] = 0
            a = queue[np.arange(n_envs), qpos]
            qpos += 1
            env, scored, tallies = apply_actions(g_step, env, a)
            # Scoring flushes the plan queue.
            qpos = np.where(scored.cpu().numpy(), qlen, qpos)
        else:
            res = plan(render_fn(env), plan_seed)
            buckets.append(plan.bucket_trace)
            a = plan_actions(res, n_envs)[0][:, 0]
            env, _, tallies = apply_actions(g_step, env, a)
        acc += tallies[:5].double().cpu().numpy()
    out = _score_stats(env.score)
    out.update({
        "scoring_events": float(acc[0]),
        "events_sq": float(acc[1]),
        "events_other": float(acc[2]),
        "score_sq": float(acc[3]) / n_envs,
        "score_other": float(acc[4]) / n_envs,
        "env": env,
        "bucket_traces": buckets,
    })
    return out
