"""Batched agent-evaluation sweep CLI (PyTorch port).

Scores a controller over thousands of vectorized environments on one card:

    python -m deep_active_inference_mc_torch.apps.sweep \
        -n flagship.npz --method ai --envs 1024 --macro 200

``-n`` takes a ``.npz`` of the JAX agent's params (README: "Weights");
without it the agent is a seeded He-uniform init. Prints one result row in
the JAX CLI's format. ``--device cpu`` runs on the CPU; the default
``cuda`` raises on a machine without a card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.train import sweep as sweep_lib
from deep_active_inference_mc_torch.utils import convert
from deep_active_inference_mc_torch.utils.device import resolve_device


def build_agent(cfg: Config, network: str, device: torch.device) -> ActiveInferenceAgent:
    """The flagship-width agent: weights from a params ``.npz`` or, when
    ``network`` is empty, a seeded init (seed 0, drawn on the CPU)."""
    agent = ActiveInferenceAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim,
                                 colour_channels=cfg.colour_channels,
                                 resolution=cfg.resolution)
    if network:
        agent.load_state_dict(convert.load_npz(network))
    else:
        agent.init(torch.Generator().manual_seed(0))
    return agent.to(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Batched agent sweep.")
    parser.add_argument("-n", "--network", type=str, default="",
                        help="Params .npz to load (seeded init if empty).")
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
    parser.add_argument("--plan_queue", action="store_true",
                        help="Enqueue the EFE action x steps, execute one entry "
                        "per macro, flush on scoring.")
    parser.add_argument("--queue_cap", type=int, default=0,
                        help="With --plan_queue: execute at most this many "
                        "entries before re-planning (0 = the whole plan).")
    parser.add_argument("--chunk", type=int, default=50,
                        help="Macro-steps per chunk (one host sync each).")
    parser.add_argument("--env_chunk", type=int, default=0,
                        help="Env-batch width per group (0 = full batch).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = Config()
    agent = build_agent(cfg, args.network, device)
    print(f"Loaded weights from {args.network}" if args.network
          else "Untrained weights (no -n).")
    lut = raster.build_sprite_lut(device)

    t0 = time.time()
    out = sweep_lib.run_sweep(
        agent, cfg, lut, seed=args.seed, n_envs=args.envs,
        method=args.method, n_macro_steps=args.macro, chunk=args.chunk,
        env_chunk=args.env_chunk or None, steps=args.steps,
        samples=args.samples, jumps=args.jumps, temperature=args.temp,
        calc_mean=not args.sample_G, crn=args.crn,
        plan_queue=args.plan_queue, queue_cap=args.queue_cap,
    )
    dt = time.time() - t0
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
    out["wall"] = dt
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
