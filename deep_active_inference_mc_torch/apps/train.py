"""Trainer CLI (PyTorch port).

    python -m deep_active_inference_mc_torch.apps.train [--resume] [--batch N]
        [--device cuda|cpu] [--epochs N] [--rounds N] [... any Config field ...]

Each epoch runs ``rounds`` training rounds on the device (on-policy data
generation + the three staged updates, ``train/loop.py``), then every
``distill_every`` epochs (0: never) an MCTS-visit distillation phase
(``train/distill.py``), evaluates (``train/evaluate.py``), scores the
fixed-seed ``ai`` and ``habit`` sweeps, appends every stats series, prints
one line and, every ``viz_every`` epochs, draws the traversal grid, the
imagination and reward-imagination strips and the two dashboards into the
run folder (``viz/``). Checkpoints go to
``<out_root>/figs_<signature>/checkpoints`` every ``save_every`` epochs, with
weight-only archives every ``archive_every``; ``--resume`` continues from the
newest one, optimizer states and random stream included. SIGINT and SIGTERM
write a resumable checkpoint and exit with code 130.

The default device is ``cuda``, and a machine without a card raises;
``--device cpu`` runs on the CPU. Matmuls and convolutions run with PyTorch's
defaults (cuDNN may use TF32 for float32 convolutions on a card).

Not ported yet, and refused with an error that names the missing part:
``--mesh_shape`` > 1 and ``--coordinator`` (parallel/mesh.py), ``--bf16``
(bf16 forwards).
"""

from __future__ import annotations

import argparse
import contextlib
import signal
import sys
import time
from pathlib import Path

import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.infer.precision import anneal_gamma
from deep_active_inference_mc_torch.ops import math as m
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.train import sweep as sweep_lib
from deep_active_inference_mc_torch.train.distill import Distiller
from deep_active_inference_mc_torch.train.evaluate import make_eval
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import stats as stats_lib
from deep_active_inference_mc_torch.utils.device import resolve_device, seeded_generator
from deep_active_inference_mc_torch.viz import generate_traversals as traversals_lib
from deep_active_inference_mc_torch.viz import nhwc
from deep_active_inference_mc_torch.viz import reconstructions_plot as recon_lib
from deep_active_inference_mc_torch.viz import stats_plot as stats_plot_lib

RUN_SEED = 0
# Fixed sweep seed: the per-epoch score series is paired across epochs
# (same initial envs, same noise stream; differences come from the weights
# only), and the constant expert/random baselines share it.
SWEEP_SEED = 20260817
ENV_STREAM, AI_STREAM, HABIT_STREAM = 0, 1, 2

# Scalar eval series copied into the stats under the same name.
_EVAL_SCALARS = (
    "F", "F_top", "F_mid", "F_down", "mse_o", "mse_o_clean", "kl_div_s", "kl_div_s_naive",
    "kl_div_pi", "kl_div_pi_min", "kl_div_pi_max", "kl_div_pi_med", "kl_div_pi_std",
    "mse_r", "deep_mse_o",
    "edge_habit_correct", "edge_habit_wrong", "edge_g_correct", "edge_g_wrong",
    "edge_g_gap_nats", "edge_g_sq_gap_nats", "edge_g_oth_gap_nats",
)
_EVAL_VECTORS = ("kl_div_s_anal", "kl_div_s_naive_anal", "kl_div_pi_anal")
_DISTILL_KEYS = ("distill_kl_first", "distill_kl_last", "distill_match_first",
                 "distill_match_last", "distill_target_entropy")


def fixed_sweep_env(cfg: Config, device) -> env_lib.EnvState:
    """The ``sweep_envs`` initial envs of every per-epoch sweep."""
    g_env = seeded_generator(device, SWEEP_SEED, ENV_STREAM)
    return env_lib.randomize(env_lib.reset(g_env, cfg.sweep_envs, device), g_env)


def sweep_generator(device, stream: int) -> torch.Generator:
    """The fixed noise stream of one per-epoch sweep."""
    return seeded_generator(device, SWEEP_SEED, stream)


def draw_figures(agent: ActiveInferenceAgent, cfg: Config, ev: dict, stats: dict,
                 folder: Path, epoch: int) -> None:
    """The epoch's figures: the traversal grid of the eval batch's samples,
    the imagination and reward-imagination strips, the two dashboards."""

    @torch.no_grad()
    def decode(s):
        return nhwc(agent.decode(torch.as_tensor(s, device=ev["s0"].device)))

    traversals_lib.generate_traversals(
        decode_fn=decode, s_dim=cfg.s_dim, s_sample=ev["s0"].cpu().numpy(),
        S_real=ev["S0_real"].cpu().numpy(),
        filenames=[folder / f"traversals_at_epoch_{epoch:04d}.png"])
    recon_lib.reconstructions_plot(
        nhwc(ev["o0"]), nhwc(ev["o1"]), nhwc(ev["po1"]),
        filename=folder / f"imagination_{cfg.signature}_{epoch}.png")
    # Does the decoded imagination of an "up" at the scoring edge paint the
    # reward strip?
    recon_lib.reconstructions_plot(
        nhwc(ev["o0_probe"]), nhwc(ev["o1_probe"]), nhwc(ev["po1_probe"]),
        filename=folder / f"reward_imagination_{cfg.signature}_{epoch}.png")
    stats_plot_lib.stats_plot(stats, folder / f"1_result_{cfg.signature}")
    stats_plot_lib.behavior_plot(stats, folder / f"2_behavior_{cfg.signature}")


def _refuse_unported(cfg: Config, known: argparse.Namespace) -> None:
    if (cfg.mesh_shape is not None and cfg.mesh_shape > 1) or known.coordinator:
        raise NotImplementedError(
            "--mesh_shape/--coordinator: multi-device training (parallel/mesh.py) is not "
            "ported yet")
    if cfg.bf16:
        raise NotImplementedError("--bf16: bfloat16 forwards are not ported yet")


@contextlib.contextmanager
def _profile(trace_dir):
    """torch.profiler trace of the enclosed block into ``trace_dir`` (no-op
    when it is None)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(trace_dir) / "epoch_trace.json"))


def main(argv=None) -> dict:
    # Interrupt-safe shutdown must work however the trainer was spawned: a
    # non-interactive shell starts background jobs with SIGINT ignored, and
    # supervisors send SIGTERM. Route both to the KeyboardInterrupt path,
    # which writes a resumable checkpoint (below).
    def _interrupt(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGINT, _interrupt)
    signal.signal(signal.SIGTERM, _interrupt)

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("-r", "--resume", action="store_true")
    parser.add_argument("-b", "--batch", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler trace of the first epoch here.")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="Multi-host runs: not ported yet.")
    known, rest = parser.parse_known_args(argv)
    overrides = {"batch": known.batch} if known.batch else {}
    cfg = Config.from_args(rest, **overrides)
    _refuse_unported(cfg, known)
    device = resolve_device(known.device)

    folder, folder_chp = cfg.folder, cfg.folder_chp
    folder_chp.mkdir(parents=True, exist_ok=True)
    cfg.save(folder / "config.json")

    agent = ActiveInferenceAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim,
                                 colour_channels=cfg.colour_channels,
                                 resolution=cfg.resolution)
    lut = raster.build_sprite_lut(device)

    # One generator carries the run's random stream (init, rounds, eval);
    # its state is checkpointed, so a resumed run continues the stream.
    gen = seeded_generator(device, RUN_SEED)
    state = train_loop.create_train_state(cfg, agent, gen, device)
    stats = stats_lib.new_stats()
    start_epoch = 1

    if known.resume and ckpt.latest_exists(folder_chp):
        state, stats = ckpt.load_all(folder_chp, state, gen)
        stats = stats_lib.pad_missing(stats)
        start_epoch = len(stats["F"]) + 1
        print(f"Resumed from {folder_chp} at epoch {start_epoch}")

    epoch_fn = train_loop.make_epoch_fn(cfg, lut, cfg.rounds)
    eval_fn = make_eval(agent, cfg, lut)
    # Per-epoch behavioural scores: an EFE-agent sweep and a cheap
    # habit-controller sweep (512 envs x 100 macro steps by default, large
    # enough that the series is a learning curve and not noise).
    score_fn = sweep_lib.make_sweep(
        agent, cfg, lut, method="ai", n_macro_steps=cfg.sweep_steps,
        steps=cfg.deepness, samples=cfg.samples, jumps=cfg.repeats)
    habit_fn = sweep_lib.make_sweep(
        agent, cfg, lut, method="habit", n_macro_steps=cfg.sweep_steps, jumps=cfg.repeats)

    distiller = Distiller(agent, cfg, lut) if cfg.distill_every > 0 else None

    sweep_env = fixed_sweep_env(cfg, device)
    sweep_base = {}
    for meth in ("random", "expert"):
        fn = sweep_lib.make_sweep(agent, cfg, lut, method=meth,
                                  n_macro_steps=cfg.sweep_steps, jumps=cfg.repeats)
        sweep_base[meth] = fn(sweep_generator(device, AI_STREAM), sweep_env)["score_mean"]
    print(
        f"sweep baselines (fixed seed, {cfg.sweep_envs} envs x "
        f"{cfg.sweep_steps} macro): random {sweep_base['random']:+.3f}, "
        f"expert {sweep_base['expert']:+.3f}", flush=True,
    )

    env_sps_log = []
    start_time = time.time()
    saver = ckpt.AsyncSaver()
    try:
        for epoch in range(start_epoch, cfg.epochs + 1):
            state.precision = anneal_gamma(
                state.precision, epoch, cfg.gamma_delay, cfg.gamma_rate, cfg.gamma_max)

            epoch_t0 = time.time()
            with _profile(known.profile_dir if epoch == start_epoch else None):
                # Ends with the transfer of the stacked metrics: a host sync.
                state, train_metrics = epoch_fn(state, gen)
            env_sps = cfg.batch * cfg.repeats * cfg.rounds / (time.time() - epoch_t0)
            env_sps_log.append(env_sps)

            # MCTS-visit distillation: sharpen the habit net against the
            # planner's root visits. It runs before the eval and the
            # checkpoint, so both see the distilled weights.
            dmetrics = {}
            if distiller is not None and epoch % cfg.distill_every == 0:
                d_t0 = time.time()
                state, dmetrics = distiller(state, gen)
                print(
                    f"  distill@{epoch}: kl {dmetrics['distill_kl_first']:.3f}"
                    f"->{dmetrics['distill_kl_last']:.3f}, match "
                    f"{dmetrics['distill_match_first']:.2f}->"
                    f"{dmetrics['distill_match_last']:.2f}, target H "
                    f"{dmetrics['distill_target_entropy']:.3f}, "
                    f"{dmetrics['distill_steps']:.0f} steps, {time.time() - d_t0:.1f}s",
                    flush=True)

            # ---- evaluation ---------------------------------------------------
            ev = eval_fn(state.precision, gen)
            scalars = dict(zip(_EVAL_SCALARS,
                               torch.stack([ev[k] for k in _EVAL_SCALARS]).tolist()))
            for k in _EVAL_SCALARS:
                stats[k].append(scalars[k])
            for k in _EVAL_VECTORS:
                stats[k].append(ev[k].cpu().numpy())
            stats["omega"].append(train_metrics["omega"])
            stats["omega_std"].append(train_metrics["omega_std"])
            stats["kl_div_pi_train"].append(train_metrics["kl_pi"])
            stats["var_beta_s"].append(float(state.precision.beta_s))
            stats["var_gamma"].append(float(state.precision.gamma))
            stats["var_beta_o"].append(float(state.precision.beta_o))
            stats["var_a"].append(cfg.var_a)
            stats["var_b"].append(cfg.var_b)
            stats["var_c"].append(cfg.var_c)
            stats["var_d"].append(cfg.var_d)
            stats["TC"].append(float(m.total_correlation(ev["qs1"].cpu().numpy())))
            stats["learning_rate"].append(cfg.l_rate_down)
            stats["current_lr"].append(cfg.l_rate_down)
            for k in ("gnorm_top", "gnorm_mid", "gnorm_down"):
                stats[k].append(train_metrics[k])
                stats[k + "_max"].append(train_metrics[k + "_max"])
            stats["F_down_round_max"].append(train_metrics["F_down_max"])
            for k in _DISTILL_KEYS:
                stats[k].append(dmetrics.get(k, 0.0))

            sc = score_fn(sweep_generator(device, AI_STREAM), sweep_env)
            sc_h = habit_fn(sweep_generator(device, HABIT_STREAM), sweep_env)
            stats["score"].append(sc["score_mean"])
            stats["train_scores_m"].append(sc["score_mean"])
            stats["train_scores_std"].append(sc["score_std"])
            stats["train_scores_sem"].append(sc["score_sem"])
            stats["train_scores_min"].append(sc["score_min"])
            stats["train_scores_max"].append(sc["score_max"])
            stats["train_scores_habit_m"].append(sc_h["score_mean"])
            stats["train_scores_habit_sem"].append(sc_h["score_sem"])
            stats["train_events_sq"].append(sc["events_sq"])
            stats["train_events_other"].append(sc["events_other"])
            stats["train_scores_sq"].append(sc["score_sq"])
            stats["train_scores_other"].append(sc["score_other"])
            stats["train_scores_expert"].append(sweep_base["expert"])
            stats["train_scores_random"].append(sweep_base["random"])

            # The save follows the epoch's stats, so a checkpoint holds the
            # weights after epoch N beside N stats entries and a resumed run
            # starts at epoch N + 1.
            if epoch % cfg.save_every == 0:
                saver.save(folder_chp, state, stats, gen, script_file=__file__)
            if epoch % cfg.archive_every == 0:
                saver.wait()  # the archive copies the checkpoint dir
                ckpt.archive(folder_chp, epoch)
            if epoch % cfg.viz_every == 0:
                draw_figures(agent, cfg, ev, stats, folder, epoch)

            print(
                f"{epoch}, F: {stats['F'][-1]:.2f}, MSEo: {stats['mse_o'][-1]:.3f} "
                f"(clean {stats['mse_o_clean'][-1]:.1f}), "
                f"KLs: {stats['kl_div_s'][-1]:.2f}, "
                f"omega: {stats['omega'][-1]:.2f}+-{stats['omega_std'][-1]:.2f}, "
                f"KLpi: {stats['kl_div_pi'][-1]:.2f}, TC: {stats['TC'][-1]:.2f}, "
                f"score: {stats['score'][-1]:.2f} "
                f"(h {stats['train_scores_habit_m'][-1]:.2f}, "
                f"sq {stats['train_scores_sq'][-1]:+.2f}/"
                f"oth {stats['train_scores_other'][-1]:+.2f}), "
                f"edge: h {stats['edge_habit_correct'][-1] - stats['edge_habit_wrong'][-1]:+.3f} "
                f"g {stats['edge_g_correct'][-1] - stats['edge_g_wrong'][-1]:+.3f}, "
                f"gn: {stats['gnorm_top'][-1]:.1f}/{stats['gnorm_mid'][-1]:.1f}/"
                f"{stats['gnorm_down'][-1]:.1f} "
                f"(max {stats['gnorm_top_max'][-1]:.0f}/{stats['gnorm_mid_max'][-1]:.0f}/"
                f"{stats['gnorm_down_max'][-1]:.0f}, Fd^ {stats['F_down_round_max'][-1]:.0f}), "
                f"env_steps/s: {env_sps:.2e}, "
                f"dur. {time.time() - start_time:.2f}s",
                flush=True,
            )
            start_time = time.time()

    except KeyboardInterrupt:
        # An interrupt saves a resumable checkpoint instead of losing up to
        # save_every epochs of work.
        print("Interrupted: saving checkpoint for --resume", flush=True)
        try:
            saver.wait()  # may re-raise a stored background-writer error
        except Exception as e:
            # A failed background save must not skip the synchronous final
            # save below.
            print(f"background save failed: {e!r}", flush=True)
        ckpt.save_all(folder_chp, state, stats, gen, script_file=__file__)
        raise SystemExit(130)
    saver.wait()
    return {"state": state, "cfg": cfg, "stats": stats, "folder": folder,
            "start_epoch": start_epoch, "env_steps_per_s": env_sps_log}


if __name__ == "__main__":
    main(sys.argv[1:])
