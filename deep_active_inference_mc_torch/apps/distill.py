"""Post-training MCTS-visit distillation stage (PyTorch port).

    python -m deep_active_inference_mc_torch.apps.distill \
        -n runs/figs_<sig>/checkpoints -o runs/distilled \
        [--iters 20] [--sweep_every 1] [--patience 0] [--keep_opt] \
        [--device cuda|cpu] [--distill_envs 256 --distill_macro 40 ...]

Port of ``deep_active_inference_mc_tpu/apps/distill.py``. Iterates
(collect planner root visits -> train the habit net on them) with the
transition net and the VAE frozen: only ``top`` and its Adam change. Each
iteration prints the phase's metrics and, every ``--sweep_every``
iterations, the habit sweep's score on the trainer's fixed sweep seed and
envs (paired across iterations). The best-scoring ``top`` weights are kept
and restored before the save, which writes a port checkpoint that the
trainer (``--resume``), the sweep CLI and the demo (``-n``) load.

``--keep_opt`` keeps the checkpoint's top Adam state; by default it is
reset, because a long soft-teacher run leaves Adam's second moments large
and the distill steps small. ``--patience N`` stops after N readouts
without a new best (0: run all ``--iters``). ``--bf16`` runs the
networks' forwards in bfloat16 (the planner scores G in float32; the habit
net's weights and Adam stay float32). The default device is ``cuda``;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from deep_active_inference_mc_torch.apps import train as train_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.train import sweep as sweep_lib
from deep_active_inference_mc_torch.train.distill import Distiller
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import compcache
from deep_active_inference_mc_torch.utils import stats as stats_lib
from deep_active_inference_mc_torch.utils.device import resolve_device, seeded_generator


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("-n", "--network", type=str, required=True,
                        help="Checkpoint dir to start from.")
    parser.add_argument("-o", "--out", type=str, required=True,
                        help="Output checkpoint dir (never the input).")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--sweep_every", type=int, default=1,
                        help="Habit-sweep readout cadence (iterations).")
    parser.add_argument("--patience", type=int, default=0,
                        help="Stop after this many sweep readouts without a new best score "
                        "(0 = run all --iters). The best-scoring habit weights are saved "
                        "either way.")
    parser.add_argument("--keep_opt", action="store_true",
                        help="Keep the checkpoint's top Adam state instead of resetting it.")
    parser.add_argument("--device", type=str, default="cuda")
    known, rest = parser.parse_known_args(argv)
    cfg = Config.from_args(rest)
    device = resolve_device(known.device)
    compcache.enable_persistent_cache()

    agent = ActiveInferenceAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim,
                                 colour_channels=cfg.colour_channels, resolution=cfg.resolution,
                                 dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
    lut = raster.build_sprite_lut(device)
    gen = seeded_generator(device, train_app.RUN_SEED)
    state = train_loop.create_train_state(cfg, agent, gen, device)
    state, stats = ckpt.load_all(known.network, state, gen)
    stats = stats_lib.pad_missing(stats)
    print(f"Loaded {known.network} (epoch {len(stats['F'])})", flush=True)
    if not known.keep_opt:
        state.opts["top"] = train_loop.make_optimizers(cfg, agent)["top"]
        print("Reset top optimizer state (pass --keep_opt to retain)", flush=True)

    distiller = Distiller(agent, cfg, lut)
    # The trainer's fixed sweep envs and habit stream: scores are paired
    # across iterations and comparable with the training log.
    sweep_env = train_app.fixed_sweep_env(cfg, device)
    habit_fn = sweep_lib.make_sweep(agent, cfg, lut, method="habit",
                                    n_macro_steps=cfg.sweep_steps, jumps=cfg.repeats)

    def habit_score():
        out = habit_fn(train_app.sweep_generator(device, train_app.HABIT_STREAM), sweep_env)
        return out["score_mean"], out["score_sem"]

    def top_weights():
        return {k: v.detach().clone() for k, v in agent.top.state_dict().items()}

    h0, sem0 = habit_score()
    print(f"iter 0: habit sweep {h0:+.3f}±{sem0:.3f} "
          f"({cfg.sweep_envs} envs x {cfg.sweep_steps} macro)", flush=True)

    # Keep the best habit by the paired sweep readout: the loop can
    # overshoot its optimum as the net chases teacher noise, so the saved
    # checkpoint carries the peak-scoring top weights, not the last.
    best_h, best_iter, best_top = h0, 0, top_weights()
    stale = 0
    readouts, metrics = [h0], []
    last = 0
    for i in range(1, known.iters + 1):
        t0 = time.time()
        state, m = distiller(state, gen)
        metrics.append(m)
        last = i
        line = (f"iter {i}: kl {m['distill_kl_first']:.3f}->{m['distill_kl_last']:.3f}, "
                f"match {m['distill_match_first']:.2f}->{m['distill_match_last']:.2f}, "
                f"target H {m['distill_target_entropy']:.3f}, {m['distill_steps']:.0f} steps")
        if i % known.sweep_every == 0 or i == known.iters:
            h, sem = habit_score()
            readouts.append(h)
            line += f", habit sweep {h:+.3f}±{sem:.3f}"
            if h > best_h:
                best_h, best_iter, best_top = h, i, top_weights()
                stale = 0
            else:
                stale += 1
        print(f"{line}, {time.time() - t0:.1f}s", flush=True)
        if known.patience and stale >= known.patience:
            print(f"Early stop: no sweep improvement in {stale} readouts "
                  f"(best {best_h:+.3f} at iter {best_iter})", flush=True)
            break

    if best_iter != known.iters:
        print(f"Restoring best habit (iter {best_iter}, sweep {best_h:+.3f})", flush=True)
        agent.top.load_state_dict(best_top)
    ckpt.save_all(known.out, state, stats, gen, script_file=__file__)
    print(f"Saved distilled checkpoint to {known.out}", flush=True)
    return {"state": state, "cfg": cfg, "metrics": metrics, "readouts": readouts,
            "best_iter": best_iter, "best_score": best_h, "iters_run": last}


if __name__ == "__main__":
    main(sys.argv[1:])
