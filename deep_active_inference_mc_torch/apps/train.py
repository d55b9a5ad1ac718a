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
newest one, optimizer states and random stream included. A run folder whose
``checkpoints/`` is a copy of a JAX checkpoint dir that holds
``torch_export.npz`` (``artifacts/run512/checkpoints{,_distilled}``) resumes
from its weights, precision and envs at the epoch after its stats, with
fresh Adams and the seeded random stream, as the JAX trainer resumes its
weight-only store; a JAX dir without the export raises. SIGINT and SIGTERM write a
resumable checkpoint and exit with code 130.

The default device is ``cuda``, and a machine without a card raises;
``--device cpu`` runs on the CPU. Matmuls and convolutions run with PyTorch's
defaults (cuDNN may use TF32 for float32 convolutions on a card).
``--bf16`` runs the networks' forwards in bfloat16 (weights, Adam and the
losses' reductions stay float32). On a card without a mesh the epoch's
rounds, the per-epoch eval pass, the sweeps and distillation's replay
steps replay captured CUDA graphs, as the JAX trainer jits its epoch, eval
and replay step (``train/loop.py``, ``train/evaluate.py``,
``train/sweep.py``, ``train/distill.py``); the first epoch of a run pays
one eager step of each and the capture.

Multi-device (``parallel/mesh.py``): ``--mesh_shape N`` trains on N ranks,
``--tp T`` of them per Megatron tensor-parallel group (N/T data-parallel
groups; ``--batch`` is the global batch and must divide by N/T). On one host
the trainer starts the N ranks itself, one per card over NCCL, or sharing
the cards over gloo when there are fewer cards than ranks (``--device cpu``:
gloo on the CPU). Across hosts, run the same command on every host with
``--coordinator <host 0's address>:<port> --num_hosts H --host_id h``; each
host starts ``N/H`` ranks (``--mesh_shape`` defaults to H). A run already
inside a ``torchrun`` group runs as its rank. Only global rank 0 writes the
config, checkpoints, stats and figures, runs the eval, the sweeps and the
distillation phase on the full weights, and prints; the other ranks follow
its random stream. A checkpoint holds the unsharded state, so mesh and
single-rank runs resume each other's. Under a mesh an interrupt exits 130
without a checkpoint of its own: the last periodic one stands.
"""

from __future__ import annotations

import argparse
import copy
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
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.train import sweep as sweep_lib
from deep_active_inference_mc_torch.train.distill import Distiller
from deep_active_inference_mc_torch.train.evaluate import make_eval
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import compcache, profiling
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


def _distill_on_primary(distiller: Distiller, state, gen: torch.Generator, cfg: Config,
                        mesh: mesh_lib.Mesh, full_agent: ActiveInferenceAgent) -> dict:
    """The distillation phase of a mesh run: the primary distills the full
    habit net with the full top Adam (both gathered), then every rank takes
    its shard of the result. Returns the phase's metrics (empty off the
    primary)."""
    top = full_agent.top
    top.load_state_dict(mesh_lib.full_state_dict(state.agent.top, mesh))
    opt_sd = mesh_lib.full_opt_state(state.opts["top"], mesh)
    box = [None]
    dmetrics = {}
    if mesh.is_primary:
        opt = train_loop.make_optimizers(cfg, full_agent)["top"]
        opt.load_state_dict(opt_sd)
        _, dmetrics = distiller(train_loop.TrainState(full_agent, {"top": opt},
                                                      state.precision, state.env), gen)
        box = [mesh_lib.to_host((top.state_dict(), opt.state_dict()))]
    torch.distributed.broadcast_object_list(box, src=0)
    top_sd, opt_sd = box[0]
    state.agent.top.load_state_dict(mesh_lib.shard_state_dict(top_sd, state.agent.top, mesh))
    state.opts["top"].load_state_dict(mesh_lib.shard_opt_state(opt_sd, state.opts["top"], mesh))
    return dmetrics


def _train(mesh, cfg: Config, known: argparse.Namespace) -> dict:
    """The trainer on one rank (``mesh`` None: the single-rank run)."""
    device = mesh.device if mesh else resolve_device(known.device)
    primary = mesh is None or mesh.is_primary
    folder, folder_chp = cfg.folder, cfg.folder_chp
    if primary:
        folder_chp.mkdir(parents=True, exist_ok=True)
        cfg.save(folder / "config.json")
    if mesh and primary:
        print(mesh.describe(), flush=True)

    agent = ActiveInferenceAgent(s_dim=cfg.s_dim, pi_dim=cfg.pi_dim,
                                 colour_channels=cfg.colour_channels,
                                 resolution=cfg.resolution,
                                 dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
    lut = raster.build_sprite_lut(device)

    # One generator carries the run's random stream (init, rounds, eval);
    # its state is checkpointed, so a resumed run continues the stream.
    # Every rank of a mesh holds the same stream.
    gen = seeded_generator(device, RUN_SEED)
    state = train_loop.create_train_state(cfg, agent, gen, device)
    stats = stats_lib.new_stats()
    start_epoch = 1

    if known.resume and ckpt.latest_exists(folder_chp):
        state, stats = ckpt.load_all(folder_chp, state, gen)
        stats = stats_lib.pad_missing(stats)
        start_epoch = len(stats["F"]) + 1
        if primary:
            print(f"Resumed from {folder_chp} at epoch {start_epoch}")

    # The eval, the sweeps and the figures run on full weights: the agent
    # itself, or under tensor parallelism a full copy refreshed each epoch.
    eval_agent = agent
    if mesh is not None:
        if mesh.n_model > 1:
            eval_agent = copy.deepcopy(agent)
        state = mesh_lib.shard_train_state(state, mesh, cfg)

    epoch_fn = train_loop.make_epoch_fn(cfg, lut, cfg.rounds, mesh)
    # On a card the eval pass replays a graph (gloo cannot be captured:
    # a mesh's runs op by op); its outputs are copies, which the figures read.
    eval_fn = make_eval(eval_agent, cfg, lut, graphed=None if mesh is None else False)
    # Per-epoch behavioural scores: an EFE-agent sweep and a cheap
    # habit-controller sweep (512 envs x 100 macro steps by default, large
    # enough that the series is a learning curve and not noise).
    score_fn = sweep_lib.make_sweep(
        eval_agent, cfg, lut, method="ai", n_macro_steps=cfg.sweep_steps,
        steps=cfg.deepness, samples=cfg.samples, jumps=cfg.repeats)
    habit_fn = sweep_lib.make_sweep(
        eval_agent, cfg, lut, method="habit", n_macro_steps=cfg.sweep_steps, jumps=cfg.repeats)

    distiller = None
    if cfg.distill_every > 0:  # a mesh run's planner runs op by op
        distiller = Distiller(eval_agent, cfg, lut, graphed=None if mesh is None else False)

    sweep_env = fixed_sweep_env(cfg, device)
    sweep_base = {}
    if primary:
        for meth in ("random", "expert"):
            fn = sweep_lib.make_sweep(eval_agent, cfg, lut, method=meth,
                                      n_macro_steps=cfg.sweep_steps, jumps=cfg.repeats)
            sweep_base[meth] = fn(sweep_generator(device, AI_STREAM), sweep_env)["score_mean"]
        print(
            f"sweep baselines (fixed seed, {cfg.sweep_envs} envs x "
            f"{cfg.sweep_steps} macro): random {sweep_base['random']:+.3f}, "
            f"expert {sweep_base['expert']:+.3f}", flush=True,
        )

    env_sps_log, round_launches = [], []
    start_time = time.time()
    saver = ckpt.AsyncSaver()
    try:
        for epoch in range(start_epoch, cfg.epochs + 1):
            state.precision = anneal_gamma(
                state.precision, epoch, cfg.gamma_delay, cfg.gamma_rate, cfg.gamma_max)

            epoch_t0 = time.time()
            k1_before = LAUNCHES["render"]
            profile_dir = known.profile_dir if epoch == start_epoch and primary else None
            with profiling.trace(profile_dir):
                # Ends with the transfer of the stacked metrics: a host sync.
                state, train_metrics = epoch_fn(state, gen)
            env_sps = cfg.batch * cfg.repeats * cfg.rounds / (time.time() - epoch_t0)
            env_sps_log.append(env_sps)
            round_launches.append(LAUNCHES["render"] - k1_before)
            if eval_agent is not agent:
                eval_agent.load_state_dict(mesh_lib.full_state_dict(state.agent, mesh))

            # MCTS-visit distillation: sharpen the habit net against the
            # planner's root visits. It runs before the eval and the
            # checkpoint, so both see the distilled weights.
            dmetrics = {}
            if distiller is not None and epoch % cfg.distill_every == 0:
                d_t0 = time.time()
                if mesh is None:
                    state, dmetrics = distiller(state, gen)
                else:
                    dmetrics = _distill_on_primary(distiller, state, gen, cfg, mesh, eval_agent)
                if primary:
                    print(
                        f"  distill@{epoch}: kl {dmetrics['distill_kl_first']:.3f}"
                        f"->{dmetrics['distill_kl_last']:.3f}, match "
                        f"{dmetrics['distill_match_first']:.2f}->"
                        f"{dmetrics['distill_match_last']:.2f}, target H "
                        f"{dmetrics['distill_target_entropy']:.3f}, "
                        f"{dmetrics['distill_steps']:.0f} steps, {time.time() - d_t0:.1f}s",
                        flush=True)

            if primary:
                ev = _evaluate(eval_fn, score_fn, habit_fn, state, gen, cfg, stats,
                               train_metrics, dmetrics, sweep_env, sweep_base, device)
            # The other ranks continue the primary's stream, which the eval
            # and the distillation drew from.
            mesh_lib.sync_generator_(gen, mesh)

            # The save follows the epoch's stats, so a checkpoint holds the
            # weights after epoch N beside N stats entries and a resumed run
            # starts at epoch N + 1.
            if epoch % cfg.save_every == 0:
                saver.save(folder_chp, state, stats, gen, script_file=__file__, mesh=mesh)
            if not primary:
                continue
            if epoch % cfg.archive_every == 0:
                saver.wait()  # the archive copies the checkpoint dir
                ckpt.archive(folder_chp, epoch)
            if epoch % cfg.viz_every == 0:
                draw_figures(eval_agent, cfg, ev, stats, folder, epoch)
            _print_epoch(epoch, stats, env_sps, start_time)
            start_time = time.time()

    except KeyboardInterrupt:
        if mesh is not None:
            # A save gathers from every rank, which may be gone by now.
            print("Interrupted: the last periodic checkpoint stands", flush=True)
            raise SystemExit(130)
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
            "start_epoch": start_epoch, "env_steps_per_s": env_sps_log,
            "round_launches": round_launches}


def _evaluate(eval_fn, score_fn, habit_fn, state, gen, cfg, stats, train_metrics, dmetrics,
              sweep_env, sweep_base, device) -> dict:
    """The epoch's eval and sweeps, appended to ``stats``; returns the
    eval's payload (the figures draw from it)."""
    ev = eval_fn(state.precision, gen)
    scalars = dict(zip(_EVAL_SCALARS, torch.stack([ev[k] for k in _EVAL_SCALARS]).tolist()))
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
    return ev


def _print_epoch(epoch: int, stats: dict, env_sps: float, start_time: float) -> None:
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


def _mesh_summary(mesh, cfg: Config, known: argparse.Namespace) -> dict:
    """One rank's run under a mesh, reduced to what crosses processes: the
    primary's stats and, from every rank, its place, its Adam step counts,
    its throughput and K1's launches inside each epoch's rounds."""
    out = _train(mesh, cfg, known)
    out["adam_steps"] = {}
    for k, opt in out.pop("state").opts.items():
        steps = [int(st["step"]) for st in opt.state_dict()["state"].values()]
        if steps:
            out["adam_steps"][k] = steps[0]
    out.update(rank=mesh.rank, mesh=mesh.describe(), backend=mesh.backend,
               device=str(mesh.device))
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("-r", "--resume", action="store_true")
    parser.add_argument("-b", "--batch", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler trace of the first epoch here.")
    # Multi-host: run the same command on every host with its own --host_id.
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of host 0 (multi-host runs).")
    parser.add_argument("--num_hosts", type=int, default=1)
    parser.add_argument("--host_id", type=int, default=None)
    known, rest = parser.parse_known_args(argv)
    overrides = {"batch": known.batch} if known.batch else {}
    cfg = Config.from_args(rest, **overrides)
    compcache.enable_persistent_cache()
    resolve_device(known.device)

    world = cfg.mesh_shape or max(known.num_hosts, 1)
    if world > 1 or mesh_lib.in_launched_group():
        mesh_lib.check_layout(world, cfg.tp, cfg.batch)
        ranks = mesh_lib.launch(_mesh_summary, (cfg, known), world=world, n_model=cfg.tp,
                                device=known.device, num_hosts=known.num_hosts,
                                host_id=known.host_id, coordinator=known.coordinator)
        return dict(ranks[0], ranks=ranks)

    # Interrupt-safe shutdown must work however the trainer was spawned: a
    # non-interactive shell starts background jobs with SIGINT ignored, and
    # supervisors send SIGTERM. Route both to the KeyboardInterrupt path,
    # which writes a resumable checkpoint.
    def _interrupt(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGINT, _interrupt)
    signal.signal(signal.SIGTERM, _interrupt)
    return _train(None, cfg, known)


if __name__ == "__main__":
    main(sys.argv[1:])
