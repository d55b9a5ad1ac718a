"""Benchmark harness of the PyTorch port: the system's north-star metrics on
one card, key for key with the JAX package's ``bench.py``.

    python -m deep_active_inference_mc_torch.bench               # on the card
    python -m deep_active_inference_mc_torch.bench --device cpu  # hours

  1. batched env steps/s: step + render (kernel K1 once per step) of
     ``ENV_BATCH`` envs, ``ENV_ITERS`` sequential steps per run;
  2. EFE MC rollouts/s: one rollout is one single-step G estimate for one
     (state, action) pair, the training configuration (mean, 1 sample);
  3. MCTS plans/s: full searches with depth-3 habit simulations, 256 envs
     planning at once (unfused, fused, fused bf16, the reference budget of
     300 repeats with and without ``expand_k`` 4, the trained habit prior
     at 256 envs, and at 1024 and 256 under the keys that ``bench.py``
     names after its bucketed planner: here the one planner, which
     compacts its batch inside its search);
  4. env steps/s inside training: the act -> plan -> step -> train round.

Prints one summary line on stderr, one line per key (its time and peak
device memory) before it, and ONE JSON line on stdout with ``bench.py``'s
keys and ``"device"``: the card's ``nvidia-smi`` name and power limit, or
``"cpu"``.

Every timed region starts after a warm-up (the kernel's build, cuDNN's
first-call setup and the graphs' captures stay outside) and is a host clock
around work that ends in ``torch.cuda.synchronize()``. The loops that
``bench.py`` runs as one compiled ``lax.scan`` (the env steps, G, the
training epoch) replay one captured CUDA graph per step on a card
(``utils/graphs.py``), each step's noise drawn eagerly in the eager loop's
order; the planner (``make_jit_planner`` as ``bench.py``'s) replays one
captured search iteration per iteration. PyTorch's TF32 and cuDNN settings are
left at their defaults, as the other entry points leave them, and printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from deep_active_inference_mc_torch.apps.sweep import build_agent
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.plan import mcts as mcts_lib
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.utils import compcache
from deep_active_inference_mc_torch.utils import graphs as graphs_lib
from deep_active_inference_mc_torch.utils.device import resolve_device, seeded_generator

ENV_BATCH = 4096
ENV_ITERS = 256
EFE_BATCH = 1024
EFE_ITERS = 8
MCTS_BATCH = 256

TARGET_ENV_STEPS = 1.0e5
TARGET_EFE_ROLLOUTS = 1.0e4

TRAINED_CHECKPOINTS = Path(__file__).resolve().parent.parent / "artifacts" / "run512" / "checkpoints"


def _sync(device: torch.device) -> None:
    """The end of a timed region: wait for the card (the CPU runs in order)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def env_step(lut: torch.Tensor, state: env_lib.EnvState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             respawn: Optional[torch.Tensor] = None):
    """One step of ``bench_env_steps``: step every env (respawns injected or
    drawn from ``generator``), render (K1 once on a card) and return the
    new state and the checksum of the strip pixel ``o[:, 0, 0, 0]``."""
    state, _ = env_lib.step(state, action, generator, respawn)
    return state, env_lib.render(lut, state)[:, 0, 0, 0].sum()


def _frames(lut: torch.Tensor, batch: int) -> torch.Tensor:
    """The frames of ``batch`` fresh envs (seed 0): one K1 launch on a card."""
    dev = lut.device
    return env_lib.render(lut, env_lib.reset(seeded_generator(dev, 0), batch, dev))


def env_step_run(lut: torch.Tensor, state: env_lib.EnvState, seed: int, iters: int,
                 graphs: Optional[graphs_lib.Graphs] = None):
    """One run of the env-step key, ``bench.py``'s scan: ``iters`` steps,
    each step's action and then its respawns drawn from the run's
    generator, the checksum summed on the device. Returns (state,
    checksum)."""
    dev = lut.device
    g = seeded_generator(dev, seed)
    xs = ((torch.randint(0, env_lib.NUM_ACTIONS, (state.batch,), generator=g, device=dev),
           env_lib.sample_latents(g, state.batch, dev)) for _ in range(iters))

    def body(carry, x):
        (state, acc), (action, respawn) = carry, x
        state, chk = env_step(lut, state, action, respawn=respawn)
        return (state, acc + chk), None

    carry = (state, torch.zeros((), device=dev))
    if graphs is None:
        return graphs_lib.eager_scan(body, carry, xs, iters)[0]
    return graphs.scan(body, carry, xs, iters, deps=lambda: [lut])[0]


def _graphs(device: torch.device, graphed: Optional[bool]) -> Optional[graphs_lib.Graphs]:
    """The runs' graphs (default: on a card), or None to run op by op."""
    return graphs_lib.Graphs() if graphs_lib.use_graphs(graphed, device) else None


@torch.inference_mode()
def bench_env_steps(lut: torch.Tensor, batch: int = ENV_BATCH, iters: int = ENV_ITERS,
                    reps: int = 3, graphed: Optional[bool] = None) -> float:
    """step + render for ``batch`` envs, ``iters`` sequential steps per run:
    one warm-up run, then ``reps`` timed runs. K1 launches
    ``iters * (1 + reps)`` times on a card. ``graphed`` (default: on a
    card) replays one captured step per step (``env_step_run``)."""
    dev = lut.device
    graphs = _graphs(dev, graphed)
    state = env_lib.reset(seeded_generator(dev, 0), batch, dev)
    state, _ = env_step_run(lut, state, 1, iters, graphs)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(reps):
        state, _ = env_step_run(lut, state, 2 + i, iters, graphs)
    _sync(dev)
    dt = time.perf_counter() - t0
    return batch * iters * reps / dt


def efe_run(agent: ActiveInferenceAgent, o: torch.Tensor, seed: int, iters: int,
            graphs: Optional[graphs_lib.Graphs] = None) -> torch.Tensor:
    """One run of the G keys, ``bench.py``'s scan: ``iters`` single-step
    G estimates of every action of ``o`` (mean G, one sample), each one's
    noise drawn from the run's generator as ``calculate_G_4_repeated``
    draws it; returns the sum of G (``bench.py`` does not read it)."""
    dev, B = o.device, o.shape[0]
    g = seeded_generator(dev, seed)
    xs = (efe.draw_rollout(agent, B, B * agent.pi_dim, g, dev, steps=1, calc_mean=True,
                           samples=1, mean_estimator=True) for _ in range(iters))

    def body(acc, d):
        G, _, _ = efe.calculate_G_4_repeated(agent, o, steps=1, calc_mean=True, samples=1,
                                             draws=d)
        return acc + G.sum(), None

    acc = torch.zeros((), device=dev)
    if graphs is None:
        return graphs_lib.eager_scan(body, acc, xs, iters)[0]
    return graphs.scan(body, acc, xs, iters,
                       deps=lambda: graphs_lib.module_deps(agent) + [o])[0]


@torch.inference_mode()
def bench_efe_rollouts(agent: ActiveInferenceAgent, lut: torch.Tensor,
                       batch: int = EFE_BATCH, iters: int = EFE_ITERS,
                       reps: int = 3, graphed: Optional[bool] = None) -> float:
    """Single-step G for ``batch`` states x every action (training config:
    calc_mean=True, samples=1), ``iters`` estimates per run: one rollout
    per (state, action) pair. ``graphed`` (default: on a card) replays one
    captured G per estimate (``efe_run``)."""
    dev = lut.device
    graphs = _graphs(dev, graphed)
    o = _frames(lut, batch)
    efe_run(agent, o, 1, iters, graphs)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(reps):
        efe_run(agent, o, 2 + i, iters, graphs)
    _sync(dev)
    dt = time.perf_counter() - t0
    return batch * agent.pi_dim * iters * reps / dt


@torch.inference_mode()
def bench_mcts_plans(agent: ActiveInferenceAgent, lut: torch.Tensor, repeats: int = 50,
                     fused: bool = False, reps: int = 3, expand_k: int = 1,
                     batch: int = MCTS_BATCH, graphed: Optional[bool] = None):
    """Batched array-MCTS planning throughput: full ``repeats``-expansion
    searches with depth-3 habit simulations, ``batch`` envs planning at
    once, on one ``make_jit_planner`` (``graphed`` as its: on a card the
    search replays a captured iteration; the warm-up plan captures it).
    Returns (plans/s, depth-cap bind fraction: no-op expands per search
    iteration from the max_depth=16 cap, mean repeats done)."""
    o = _frames(lut, batch)
    p = mcts_lib.MCTSParams(repeats=repeats, simulation_depth=3, max_depth=16,
                            fused_eval=fused, expand_k=expand_k)
    planner = mcts_lib.make_jit_planner(agent, p, graphed=graphed)
    planner(o, (1,))
    _sync(lut.device)
    t0 = time.perf_counter()
    capped = done = 0.0
    for i in range(reps):
        res = planner(o, (2 + i,))
        capped += float(res.depth_capped.sum())
        done += float(res.repeats_done.sum())
    _sync(lut.device)
    dt = time.perf_counter() - t0
    return batch * reps / dt, capped / max(done, 1.0), done / (batch * reps)


def bench_train_round(lut: torch.Tensor, batch: int = 512, bf16: bool = False,
                      rounds: int = 16, reps: int = 3, graphed: Optional[bool] = None) -> float:
    """The act -> plan -> step -> train round (data generation and the
    three staged Adam updates, K1 twice per round): env steps/s inside
    training at a batch and precision. One warm-up epoch of ``rounds``
    rounds, then ``reps`` timed epochs; ``graphed`` as ``make_epoch_fn``'s
    (default: one captured round replayed per round on a card)."""
    dev = lut.device
    cfg = Config(batch=batch, bf16=bf16)
    agent = ActiveInferenceAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim,
                                 dtype=torch.bfloat16 if bf16 else torch.float32)
    state = train_loop.create_train_state(cfg, agent, seeded_generator(dev, 0), dev)
    epoch_fn = train_loop.make_epoch_fn(cfg, lut, rounds, graphed=graphed)
    state, _ = epoch_fn(state, seeded_generator(dev, 1))
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(reps):
        state, _ = epoch_fn(state, seeded_generator(dev, 2 + i))
    _sync(dev)
    dt = time.perf_counter() - t0
    return cfg.batch * cfg.repeats * rounds * reps / dt


def _try_load_trained_agent(device: torch.device,
                            checkpoints: Path = TRAINED_CHECKPOINTS
                            ) -> Optional[ActiveInferenceAgent]:
    """The committed flagship (read through its ``torch_export.npz``),
    computing in bf16, or None when the directory is absent.

    The untrained MCTS numbers are the worst case: a uniform habit prior
    never fires the planner's early exits. With the trained prior most envs
    decide in far fewer than the budgeted expansions. Unlike ``bench.py``,
    a directory that is present but does not load raises."""
    if not checkpoints.exists():
        return None
    return build_agent(Config(), str(checkpoints), device, torch.bfloat16)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``"cpu"``: no CPU number can pass for the card's."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Benchmark of the port's paths on one card.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu.")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    compcache.enable_persistent_cache()
    label = device_label(dev)
    lut = raster.build_sprite_lut(dev)
    cfg = Config()
    agent = build_agent(cfg, "", dev)
    # The same float32 weights (seed 0), computing in bf16.
    agent_bf16 = build_agent(cfg, "", dev, torch.bfloat16)

    def timed(key, fn, *a, **kw):
        """``fn``'s result, after a stderr line with its wall (warm-ups
        included) and peak device memory."""
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        wall = time.perf_counter() - t0
        peak = (f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB"
                if dev.type == "cuda" else "not measured")
        rate = out[0] if isinstance(out, tuple) else out
        print(f"# {key}: {rate:.6e} in {wall:.2f}s, peak memory {peak}", file=sys.stderr,
              flush=True)
        return out

    env_sps = timed("env_steps_per_sec", bench_env_steps, lut)
    efe_rps = timed("efe_rollouts_per_sec", bench_efe_rollouts, agent, lut)
    efe_rps_bf16 = timed("efe_rollouts_per_sec_bf16", bench_efe_rollouts, agent_bf16, lut)
    # The MCTS ladder: unfused f32 -> fused -> fused+bf16, then the
    # reference budget (300 repeats) with the max_depth=16 cap-bind
    # fraction, and with expand_k=4 (4 expansions per sequential iteration).
    mcts_pps, _, _ = timed("mcts_plans_per_sec", bench_mcts_plans, agent, lut, repeats=50,
                           reps=10)
    mcts_fused, _, _ = timed("mcts_plans_per_sec_fused", bench_mcts_plans, agent, lut,
                             repeats=50, fused=True)
    mcts_fused_bf16, _, _ = timed("mcts_plans_per_sec_fused_bf16", bench_mcts_plans,
                                  agent_bf16, lut, repeats=50, fused=True)
    mcts_ref, cap_frac, _ = timed("mcts_plans_per_sec_ref_budget", bench_mcts_plans,
                                  agent_bf16, lut, repeats=300, fused=True, reps=1)
    mcts_ref_k4, cap_frac_k4, _ = timed("mcts_plans_per_sec_ref_budget_k4", bench_mcts_plans,
                                        agent_bf16, lut, repeats=300, fused=True, reps=1,
                                        expand_k=4)
    # The deployed planning rate: the same search with the trained habit
    # prior, where the early exits fire.
    trained = _try_load_trained_agent(dev)
    mcts_trained = avg_reps_trained = mcts_trained_bucketed = None
    mcts_trained_bucketed_b256 = None
    if trained is not None:
        mcts_trained, _, avg_reps_trained = timed(
            "mcts_plans_per_sec_ref_budget_trained", bench_mcts_plans, trained, lut,
            repeats=300, fused=True, reps=3)
        mcts_trained_bucketed, _, _ = timed(
            "mcts_plans_per_sec_ref_budget_trained_bucketed", bench_mcts_plans, trained, lut,
            repeats=300, fused=True, reps=3, batch=1024)
        mcts_trained_bucketed_b256, _, _ = timed(
            "mcts_plans_per_sec_ref_budget_trained_bucketed_b256", bench_mcts_plans, trained,
            lut, repeats=300, fused=True, reps=3, batch=256)
    train_sps = timed("train_env_steps_per_sec", bench_train_round, lut, batch=512)
    train_bf16 = timed("train_env_steps_per_sec_bf16", bench_train_round, lut, batch=512,
                       bf16=True)
    train_2048 = timed("train_env_steps_per_sec_b2048_bf16", bench_train_round, lut,
                       batch=2048, bf16=True, reps=2)

    print(
        f"env_steps/s: {env_sps:.3e} (target {TARGET_ENV_STEPS:.0e}), "
        f"efe_rollouts/s: {efe_rps:.3e} (target {TARGET_EFE_ROLLOUTS:.0e}) "
        f"| bf16 {efe_rps_bf16:.3e}, "
        f"mcts_plans/s: {mcts_pps:.3e} (50 exp, depth-3 sims) | fused "
        f"{mcts_fused:.3e} | fused+bf16 {mcts_fused_bf16:.3e} | ref-budget "
        f"300exp {mcts_ref:.3e} (cap binds {cap_frac:.1%}) | +k4 "
        f"{mcts_ref_k4:.3e} (cap binds {cap_frac_k4:.1%})"
        + (
            f" | trained-prior {mcts_trained:.3e} "
            f"(avg {avg_reps_trained:.0f}/300 expansions) | B=1024 "
            f"{mcts_trained_bucketed:.3e} (B=256 "
            f"{mcts_trained_bucketed_b256:.3e})"
            if mcts_trained is not None
            else ""
        )
        + f", train_env_steps/s: {train_sps:.3e} (b512) "
        f"| bf16 {train_bf16:.3e} | b2048+bf16 {train_2048:.3e}"
        f" [{label}; cuBLAS TF32 {torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}, cuDNN benchmark "
        f"{torch.backends.cudnn.benchmark}]",
        file=sys.stderr,
    )
    result = {
        "metric": "env_steps_per_sec",
        "value": env_sps,
        "unit": "steps/s",
        "vs_baseline": env_sps / TARGET_ENV_STEPS,
        "efe_rollouts_per_sec": efe_rps,
        "efe_rollouts_per_sec_bf16": efe_rps_bf16,
        "efe_vs_baseline": efe_rps / TARGET_EFE_ROLLOUTS,
        "mcts_plans_per_sec": mcts_pps,
        "mcts_plans_per_sec_fused": mcts_fused,
        "mcts_plans_per_sec_fused_bf16": mcts_fused_bf16,
        "mcts_plans_per_sec_ref_budget": mcts_ref,
        "mcts_plans_per_sec_ref_budget_k4": mcts_ref_k4,
        "mcts_depth_cap_bind_frac": cap_frac,
        "mcts_depth_cap_bind_frac_k4": cap_frac_k4,
        "mcts_plans_per_sec_ref_budget_trained": mcts_trained,
        "mcts_trained_avg_expansions": avg_reps_trained,
        "mcts_plans_per_sec_ref_budget_trained_bucketed": mcts_trained_bucketed,
        "mcts_plans_per_sec_ref_budget_trained_bucketed_b256": mcts_trained_bucketed_b256,
        "train_env_steps_per_sec": train_sps,
        "train_env_steps_per_sec_bf16": train_bf16,
        "train_env_steps_per_sec_b2048_bf16": train_2048,
        "device": label,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
