"""Batched agent-evaluation sweep CLI (PyTorch port).

Scores a controller over thousands of vectorized environments on one card:

    python -m deep_active_inference_mc_torch.apps.sweep \
        -n artifacts/run512/checkpoints --method ai --envs 1024 --macro 200

    python -m deep_active_inference_mc_torch.apps.sweep \
        --method mcts --envs 256 --macro 20 --mcts_fused
    python -m deep_active_inference_mc_torch.apps.sweep \
        --method mcts --envs 512 --mcts_bucketed --plan_queue --mcts_c 2

``-n`` takes a port checkpoint dir (the trainer's or ``apps/distill.py``'s),
a JAX checkpoint dir that holds ``torch_export.npz`` (the committed flagship,
``artifacts/run512/checkpoints``, or the distilled agent it was resumed from,
``artifacts/run512/checkpoints_distilled``) or a ``.npz`` of the JAX agent's params
(README: "Weights"); without it the agent is a seeded He-uniform init. Prints one result row in
the JAX CLI's format. ``--device cpu`` runs on the CPU; the default
``cuda`` raises on a machine without a card.

``--bf16`` runs the networks' forwards in bfloat16 (G is scored in
float32). ``--mesh`` shards the envs over one rank per visible card
(``--mesh N``: N ranks; ranks share a card over gloo when there are fewer
cards, and run on the CPU with ``--device cpu``); the ``ai``, ``t1``,
``t12``, ``habit``, ``random`` and ``expert`` scores equal the single-rank
sweep's at the same seed (``train/sweep.py``). The bucketed planner runs on
one rank. On a card without a mesh, every method but ``mcts`` replays one
captured CUDA graph per macro step (``utils/graphs.py``), and ``mcts`` (plain
or bucketed) one per search iteration of its planner; ``main(argv,
graphed=False)`` runs the same steps op by op, for comparison.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
from deep_active_inference_mc_torch.plan.mcts import MCTSParams
from deep_active_inference_mc_torch.train import sweep as sweep_lib
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import compcache, convert
from deep_active_inference_mc_torch.utils.device import resolve_device


def build_agent(cfg: Config, network: str, device: torch.device,
                dtype=torch.float32) -> ActiveInferenceAgent:
    """The flagship-width agent computing in ``dtype``: weights from a
    checkpoint dir (the port's, or a JAX one with its export) or a params
    ``.npz`` or, when ``network`` is empty, a seeded init (seed 0, drawn on
    the CPU)."""
    agent = ActiveInferenceAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim,
                                 colour_channels=cfg.colour_channels,
                                 resolution=cfg.resolution, dtype=dtype)
    if network and Path(network).is_dir():
        ckpt.load_weights(network, agent)
    elif network:
        agent.load_state_dict(convert.load_npz(network))
    else:
        agent.init(torch.Generator().manual_seed(0))
    return agent.to(device)


def main(argv=None, graphed: Optional[bool] = None) -> dict:
    parser = argparse.ArgumentParser(description="Batched agent sweep.")
    parser.add_argument("-n", "--network", type=str, default="",
                        help="Checkpoint dir (the port's, or a JAX one with "
                        "torch_export.npz) or params .npz to load (seeded init if empty).")
    parser.add_argument("--method", type=str, default="ai", choices=sweep_lib.METHODS)
    parser.add_argument("--envs", type=int, default=1024)
    parser.add_argument("--macro", type=int, default=100,
                        help="Macro-steps (plan->act cycles).")
    parser.add_argument("--steps", type=int, default=1)
    parser.add_argument("--samples", type=int, default=1)
    parser.add_argument("--jumps", type=int, default=5)
    parser.add_argument("--temp", type=float, default=1.0)
    parser.add_argument("--crn", action="store_true",
                        help="Common random numbers across the 4 candidate "
                        "actions for the ai/t1/t12 controllers.")
    parser.add_argument("--sample_G", action="store_true",
                        help="Sample latents for G instead of means "
                        "(the reference demo's default; pair with --samples 10).")
    parser.add_argument("--mcts_repeats", type=int, default=50)
    parser.add_argument("--mcts_depth", type=int, default=3)
    parser.add_argument("--mcts_c", type=float, default=1.0,
                        help="Exploration constant C (reference default 1.0).")
    parser.add_argument("--mcts_prior_explore", action="store_true",
                        help="Weight the selection bonus by the habit prior "
                        "Q(pi|s): the reference's using_prior_for_exploration "
                        "mode (default off there too). Pays off once the habit "
                        "net is distilled.")
    parser.add_argument("--mcts_habit", action="store_true",
                        help="Phase-A habit short-circuit (reference use_habit): "
                        "skip the search when habit confidence exceeds "
                        "--mcts_threshold.")
    parser.add_argument("--mcts_threshold", type=float, default=0.5,
                        help="Phase A/B decision confidence threshold.")
    parser.add_argument("--mcts_crn", action="store_true",
                        help="Common random numbers across actions in node "
                        "expansions (unfused evaluator only).")
    parser.add_argument("--mcts_fused", action="store_true",
                        help="Mega-batched expand+simulate evaluator (same "
                        "estimators, one pass per network per iteration; "
                        "plan/mcts.py:_fused_expand_sim).")
    parser.add_argument("--mcts_bucketed", action="store_true",
                        help="Host-driven batch-compaction planner: decided envs "
                        "retire at iteration checkpoints, stragglers re-pack "
                        "into smaller buckets "
                        "(plan/mcts.py:make_bucketed_planner). mcts only.")
    parser.add_argument("--mcts_check_every", type=int, default=16,
                        help="Bucketed planner: iterations between "
                        "retire/compaction checks.")
    parser.add_argument("--mcts_min_bucket", type=int, default=32,
                        help="Bucketed planner: smallest compaction bucket.")
    parser.add_argument("--plan_queue", action="store_true",
                        help="Reference full-plan execution protocol: enqueue "
                        "the whole MCTS path / the EFE action x steps, execute "
                        "one entry per macro, flush on scoring. Default: "
                        "re-plan every macro (first path action only).")
    parser.add_argument("--queue_cap", type=int, default=0,
                        help="With --plan_queue: execute at most this many "
                        "plan entries before re-planning (0 = the whole plan, "
                        "the reference protocol; 1 = re-plan every macro).")
    parser.add_argument("--chunk", type=int, default=50,
                        help="Macro-steps per chunk (one host sync each).")
    parser.add_argument("--env_chunk", type=int, default=0,
                        help="Env-batch width per group (0 = full batch).")
    parser.add_argument("--mesh", type=int, nargs="?", const=0, default=None,
                        help="Shard the envs over one rank per visible card (--mesh N: "
                        "N ranks).")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 model forwards (G scoring stays float32); the "
                        "planner's fused+bf16 fast path.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.mcts_bucketed and args.method != "mcts":
        raise SystemExit("--mcts_bucketed requires --method mcts")

    device = resolve_device(args.device)
    compcache.enable_persistent_cache()
    if args.mesh is not None and not args.mcts_bucketed:
        world = args.mesh or (torch.cuda.device_count() if device.type == "cuda" else 1)
        if world > 1 or mesh_lib.in_launched_group():
            return mesh_lib.launch(_sweep, (args,), world=world, device=args.device)[0]
    return _sweep(None, args, graphed)


def _sweep(mesh, args: argparse.Namespace, graphed: Optional[bool] = None) -> dict:
    """The sweep on one rank (``mesh`` None: the single-rank run); ``graphed``
    as ``train.sweep.make_sweep``'s."""
    device = mesh.device if mesh else resolve_device(args.device)
    primary = mesh is None or mesh.is_primary
    cfg = Config()
    agent = build_agent(cfg, args.network, device,
                        torch.bfloat16 if args.bf16 else torch.float32)
    if primary:
        if mesh is not None:
            print(mesh.describe(), flush=True)
        print(f"Loaded weights from {args.network}" if args.network
              else "Untrained weights (no -n).")
    lut = raster.build_sprite_lut(device)

    mcts_params = MCTSParams(
        repeats=args.mcts_repeats, simulation_depth=args.mcts_depth,
        max_depth=16, fused_eval=args.mcts_fused, crn=args.mcts_crn,
        C=args.mcts_c, threshold=args.mcts_threshold,
        using_prior_for_exploration=args.mcts_prior_explore,
        use_habit=args.mcts_habit,
    )
    t0 = time.time()
    if args.mcts_bucketed:
        out = sweep_lib.run_sweep_bucketed(
            agent, cfg, lut, seed=args.seed, n_envs=args.envs,
            n_macro_steps=args.macro, jumps=args.jumps, mcts_params=mcts_params,
            check_every=args.mcts_check_every, min_bucket=args.mcts_min_bucket,
            plan_queue=args.plan_queue, queue_cap=args.queue_cap, graphed=graphed,
        )
    else:
        out = sweep_lib.run_sweep(
            agent, cfg, lut, seed=args.seed, n_envs=args.envs,
            method=args.method, n_macro_steps=args.macro, chunk=args.chunk,
            env_chunk=args.env_chunk or None, steps=args.steps,
            samples=args.samples, jumps=args.jumps, temperature=args.temp,
            calc_mean=not args.sample_G, crn=args.crn, mcts_params=mcts_params,
            plan_queue=args.plan_queue, queue_cap=args.queue_cap, mesh=mesh,
            graphed=graphed,
        )
    dt = time.time() - t0
    out["wall"] = dt
    if not primary:
        return out
    frames = args.envs * args.macro * args.jumps
    queued = args.plan_queue and args.method in sweep_lib.QUEUE_METHODS
    label = ("+queue" + (f"cap{args.queue_cap}" if args.queue_cap else "")) if queued else ""
    print(
        f"method={args.method}{label} "
        f"ckpt={args.network or 'untrained'} "
        f"seed={args.seed} envs={args.envs} macro={args.macro} "
        f"score: {out['score_mean']:.3f} +- {out['score_sem']:.3f} "
        f"(std {out['score_std']:.3f}, min {out['score_min']:.2f}, "
        f"max {out['score_max']:.2f}) "
        f"scoring_events={int(out['scoring_events'])} "
        f"events_sq={int(out['events_sq'])} events_other={int(out['events_other'])} "
        f"score_sq={out['score_sq']:.3f} score_other={out['score_other']:.3f} "
        f"env_steps/s={frames / dt:.3e} wall={dt:.1f}s",
        flush=True,
    )
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
