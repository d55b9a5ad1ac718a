"""Causal-model trainer CLI (PyTorch port).

    python -m deep_active_inference_mc_torch.apps.train_causal [--resume]
        [--batch N] [--l_rate 1e-4] [--device cuda|cpu] [... any Config field ...]

Port of ``deep_active_inference_mc_tpu/apps/train_causal.py``: one Adam
over the whole structural causal model, gamma annealing, checkpoints every
``save_every`` epochs with weight-only archives every ``archive_every``,
and per epoch an eval with a counterfactual probe, the stats series, one
line (with ``cf_effect``) and the traversal and reconstruction figures.
Runs go to ``<out_root>/figs_causal_model_<...>``. ``--resume`` continues
from the newest checkpoint, optimizer state and random stream included;
SIGINT and SIGTERM write a resumable checkpoint and exit with code 130.
The default device is ``cuda``; ``--device cpu`` runs on the CPU. On a
card the epochs' rounds, the eval pass and the traversals' decode (one
shape per epoch, as the JAX CLI jits ``decode_fn``) replay captured CUDA
graphs (``train/causal.py``); on the CPU they run op by op.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.precision import anneal_gamma
from deep_active_inference_mc_torch.models.causal import StructuralCausalModel
from deep_active_inference_mc_torch.train import causal as causal_lib
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import stats as stats_lib
from deep_active_inference_mc_torch.utils import compcache
from deep_active_inference_mc_torch.utils import graphs as graphs_lib
from deep_active_inference_mc_torch.utils.device import resolve_device, seeded_generator
from deep_active_inference_mc_torch.viz import generate_traversals as traversals_lib
from deep_active_inference_mc_torch.viz import nhwc
from deep_active_inference_mc_torch.viz import reconstructions_plot as recon_lib

RUN_SEED = 0


def main(argv=None) -> dict:
    def _interrupt(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGINT, _interrupt)
    signal.signal(signal.SIGTERM, _interrupt)

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("-r", "--resume", action="store_true")
    parser.add_argument("-b", "--batch", type=int, default=None)
    parser.add_argument("--l_rate", type=float, default=1e-4)
    parser.add_argument("--device", type=str, default="cuda")
    known, rest = parser.parse_known_args(argv)
    overrides = {"batch": known.batch} if known.batch else {}
    cfg = Config.from_args(rest, prefix="causal_model_", **overrides)
    device = resolve_device(known.device)
    compcache.enable_persistent_cache()

    folder, folder_chp = cfg.folder, cfg.folder_chp
    folder_chp.mkdir(parents=True, exist_ok=True)
    cfg.save(folder / "config.json")

    model = StructuralCausalModel(s_dim=cfg.s_dim, colour_channels=cfg.colour_channels,
                                  resolution=cfg.resolution)
    lut = raster.build_sprite_lut(device)
    gen = seeded_generator(device, RUN_SEED)
    state = causal_lib.create_causal_state(cfg, model, gen, device, known.l_rate)
    stats = stats_lib.new_stats()
    start_epoch = 1
    if known.resume and ckpt.latest_exists(folder_chp):
        state, stats = ckpt.load_all(folder_chp, state, gen)
        stats = stats_lib.pad_missing(stats)
        start_epoch = len(stats["F"]) + 1
        print(f"Resumed from {folder_chp} at epoch {start_epoch}")

    epoch_fn = causal_lib.make_causal_epoch(cfg, lut, cfg.rounds)
    eval_fn = causal_lib.make_causal_eval(cfg, lut)
    decode_graphs = graphs_lib.Graphs() if graphs_lib.use_graphs(None, device) else None

    @torch.no_grad()
    def decode(s):
        s = torch.as_tensor(s, device=device)
        if decode_graphs is None:
            return nhwc(model.decode(s))
        return nhwc(decode_graphs.call(model.decode, (s,),
                                       deps=lambda: graphs_lib.module_deps(model)))

    epoch_s = []
    start_time = time.time()
    try:
        for epoch in range(start_epoch, cfg.epochs + 1):
            state.precision = anneal_gamma(
                state.precision, epoch, cfg.gamma_delay, cfg.gamma_rate, cfg.gamma_max)
            t0 = time.time()
            state, _ = epoch_fn(state, gen)  # ends with a host sync
            epoch_s.append(time.time() - t0)

            ev = eval_fn(model, state.precision, gen)
            scalars = dict(zip(("F", "mse_o", "kl_div_s", "omega", "cf_effect"), torch.stack(
                [ev[k] for k in ("F", "mse_o", "kl_div_s", "omega", "cf_effect")]).tolist()))
            for k in ("F", "mse_o", "kl_div_s", "omega"):
                stats[k].append(scalars[k])
            stats["omega_std"].append(0.0)
            stats["var_beta_s"].append(float(state.precision.beta_s))
            stats["var_gamma"].append(float(state.precision.gamma))
            stats["var_beta_o"].append(float(state.precision.beta_o))
            stats["var_a"].append(cfg.var_a)
            stats["var_b"].append(cfg.var_b)
            stats["var_c"].append(cfg.var_c)
            stats["var_d"].append(cfg.var_d)
            stats["learning_rate"].append(known.l_rate)
            stats["current_lr"].append(known.l_rate)

            # The save follows the epoch's stats: a checkpoint holds the
            # weights after epoch N beside N stats entries.
            if epoch % cfg.save_every == 0:
                ckpt.save_all(folder_chp, state, stats, gen, script_file=__file__)
            if epoch % cfg.archive_every == 0:
                ckpt.archive(folder_chp, epoch)

            traversals_lib.generate_traversals(
                decode_fn=decode, s_dim=cfg.s_dim, s_sample=ev["s"].cpu().numpy(),
                S_real=ev["S0_real"].cpu().numpy(),
                filenames=[folder / f"traversals_at_epoch_{epoch:04d}.png"])
            recon_lib.reconstructions_plot(
                nhwc(ev["o0"][:7]), nhwc(ev["o1"][:7]), nhwc(ev["x_recon"][:7]),
                filename=folder / f"imagination_{cfg.signature}_{epoch}.png")

            print(
                f"{epoch}, F: {stats['F'][-1]:.4f}, MSEo: {stats['mse_o'][-1]:.4f}, "
                f"KLs: {stats['kl_div_s'][-1]:.2f}, omega: {stats['omega'][-1]:.2f}, "
                f"cf_effect: {scalars['cf_effect']:.4f}, "
                f"dur. {time.time() - start_time:.2f}s",
                flush=True,
            )
            start_time = time.time()
    except KeyboardInterrupt:
        print("Interrupted: saving checkpoint for --resume", flush=True)
        ckpt.save_all(folder_chp, state, stats, gen, script_file=__file__)
        raise SystemExit(130)
    return {"state": state, "stats": stats, "folder": folder, "start_epoch": start_epoch,
            "epoch_seconds": epoch_s, "graphs": {"epoch": epoch_fn.graphs,
                                                 "eval": eval_fn.graphs,
                                                 "decode": decode_graphs}}


if __name__ == "__main__":
    main(sys.argv[1:])
