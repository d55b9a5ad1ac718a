#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # adds torch.profiler breakdowns of two
                                     # ai macro steps (after phase 3) and of
                                     # two training rounds (after phase 4)
    python3 chip_smoke.py --profile --trace-dir DIR  # and their chrome traces

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name and power limit; build every CUDA kernel
     from this checkout's sources (one nvcc per source, all in parallel).
  2. kernel K1 (frame render) against its plain PyTorch version, bit for
     bit (tolerance 0) at every batch the two paths give it (512 training
     rounds and sweeps, 1000 eval frames, 1024 sweep envs, and the edge
     probe's own 96 latents with no reward shown) and at 1, 33 and 4096; at
     1 (the floor of the timing method), 512, 1024 and 4096 the
     device time of one call of each (median of 100 calls queued behind a
     sleep kernel, after a discarded pass of the same and a burst of work
     that raises the clocks, CUDA events around each call, L2 evicted
     before each call as the network passes evict it on the main path;
     K1's times with a warm L2 and with a dirty one beside them, and its
     time per call of 100 back to back inside one pair of events) and
     K1's bound from the bytes this data needs.
  3. the serving path at full width: the sweep CLI's ``main`` with the
     ``ai`` controller (mean G, 1 step, 1 sample, 5 jumps) at 1024 envs for
     20 macro steps, then ``habit``, on the seeded flagship-width agent.
     Launch counts are zeroed just before each run and read just after.
  4. the training path at full width: the trainer CLI's ``main`` at batch
     512 with the flagship's generator flags (depth cut: 20 rounds per
     epoch, 2 epochs, 10-step sweeps), saving every epoch and archiving
     the second; then the same with ``--resume --epochs 3``. Checks: every
     stats series finite, the dropout-free pixel NLL of epoch 3 below
     epoch 1's, the resumed run starts at epoch 3 with the Adam step counts
     continuing, the archive holds no optimizer state, K1 launched exactly
     twice per training round. Prints ms per round, train env-steps/s and
     peak device memory.
  5. card against CPU: env render, networks and G on 8 envs with injected
     noise, with TF32 off (then the max differences with the defaults);
     then one training round at batch 8 with injected noise: the three
     losses within 1e-4 and the three gradient norms within 1e-3
     (relative) of the CPU's.
  6. one JSON line describing every hand-written kernel, the card's
     ``nvidia-smi`` name and power limit, and the result line
     ``{"ok": true, "device": {...}}`` last. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "deep_active_inference_mc_torch"

SWEEP_ENVS = 1024
SWEEP_MACRO = 20
JUMPS = 5
TIMING_REPS = 100
SLEEP_CYCLES = 400_000_000  # ~0.2 s at Hopper's clocks: covers the host's enqueue
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2
CARD_VS_CPU_ENVS = 8
# The training phase: the flagship's batch and generator flags (without
# freeze_top, so that all three Adams step), depth cut.
TRAIN_BATCH = 512
TRAIN_ROUNDS = 20  # the flagship run's epochs have 1000
TRAIN_EPOCHS = 2  # then one more after --resume
TRAIN_SWEEP_STEPS = 10  # the trainer's default is 100
TRAIN_TEST_SIZE = 1000
TRAIN_SWEEP_ENVS = 512
# K1 is held to its plain version at every batch the two paths give it
# (the edge probe's 96 rows are a case of their own in phase_render) and at
# a 1-env, an odd and a large one; timed where a path spends its launches.
RENDER_CHECK_B = sorted({1, 33, TRAIN_BATCH, TRAIN_SWEEP_ENVS, TRAIN_TEST_SIZE,
                         SWEEP_ENVS, 4096})
RENDER_TIME_B = (1, TRAIN_BATCH, SWEEP_ENVS, 4096)  # B=1: the timing method's floor
TRAIN_FLAGS = ["--crn", "--gen_mean", "--explore_eps", "0.1", "--edge_frac", "0.3",
               "--gen_habit_mix", "0.5"]
EVAL_RENDERS = 5  # K1 launches of one eval pass: 4 at test_size, the edge probe's 96
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3  # one round, card against CPU, TF32 off
NET_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 forwards, as tests/test_torch_models.py
G_TOL = dict(rtol=1e-4, atol=1e-2)  # G sums ~4k entropies, as tests/test_efe.py

# HBM bandwidth (bytes/s) by card, from NVIDIA's data sheets. Any other
# H100 name is taken as the SXM part.
_HBM = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def hbm_bytes_per_s(name: str) -> float:
    for key, bw in _HBM:
        if key in name:
            return bw
    fail(f"no HBM bandwidth on record for card {name!r}")


def time_ms(torch, fn, flush=None, reps: int = TIMING_REPS) -> tuple:
    """(25th, 50th, 75th) percentile device time of one call of ``fn``.
    All calls are enqueued while a sleep kernel holds the card, so no call
    waits on the host; each call sits between its own pair of CUDA
    events, with ``flush`` (if given) run before it, outside the events.
    Two such passes run and the first is discarded: its window was seen
    to be disturbed (wide quartiles) while the second's is not."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        for start, end in events:
            if flush is not None:
                flush()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
    q1, q2, q3 = statistics.quantiles((s.elapsed_time(e) for s, e in events), n=4)
    return q1, q2, q3


def time_back_to_back_ms(torch, fn, reps: int = TIMING_REPS, passes: int = 5) -> float:
    """Device time per call of ``reps`` calls of ``fn`` between ONE pair of
    events (queued behind a sleep kernel; median of ``passes`` such runs
    after a discarded one): what a call costs with no event on either side
    of it, the L2 warm. Beside ``time_ms`` without a flush it shows how much
    of a per-call time is the events' own."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(passes + 1):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call[1:])


def warm_up_clocks(torch, dev, seconds: float = 0.5) -> None:
    """Keep the card busy long enough for its clocks to rise, so the first
    timed call is not taken at idle clocks."""
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def to_device(x, d):
    """``x`` with every tensor moved to ``d`` (tensors, dicts, lists, tuples
    and dataclasses such as EnvState and the G draws)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(d)
    if isinstance(x, dict):
        return {k: to_device(v, d) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, d) for v in x)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_device(getattr(x, f.name), d)
                          for f in dataclasses.fields(x)})
    return x


def render_bound_bytes(torch, lut, idx, r0, c0) -> int:
    """Bytes K1 must move for these inputs: each LUT pixel that some
    window covers read once, 16 B of inputs per env, each frame written
    once."""
    from deep_active_inference_mc_torch.envs import raster

    used = torch.zeros(lut.shape, dtype=torch.bool, device=lut.device)
    ar = torch.arange(raster.RES, device=lut.device)
    used[idx.long()[:, None, None], (r0.long()[:, None] + ar)[:, :, None],
         (c0.long()[:, None] + ar)[:, None, :]] = True
    B = idx.shape[0]
    return 4 * int(used.sum()) + 16 * B + 4 * B * raster.RES ** 2


def phase_render(torch, dev, bw: float, smi: str) -> dict:
    """K1 against its plain version; times and bound at the timed sizes."""
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import render as k_render
    from deep_active_inference_mc_torch.train import evaluate

    gen = torch.Generator(device=dev).manual_seed(1)
    lut = raster.build_sprite_lut(dev)
    # Evicting the L2 by reading a larger buffer leaves it clean; writing
    # one (zero_) leaves it dirty, and the next kernel then pays for
    # writing that buffer back. Both are timed; the clean one is K1's.
    l2 = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush, flush_dirty = l2.sum, l2.zero_
    k1 = {}

    def hold(label, latents, last_r):
        """K1 == plain on these inputs; returns (kernel inputs, max |diff|)."""
        args = k_render.frame_inputs(latents, last_r)
        got = k_render.render_frames_cuda(lut, *args)
        want = k_render.render_frames_plain(lut, *args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.equal(got, want), f"K1 differs from its plain version at {label}: "
              f"max |diff| {err}")
        print(f"[render] {label}: K1 == plain, bit for bit (tolerance 0, max_abs_err {err})")
        return args, err

    # The eval pass's edge probe: 96 rows at posY=31, last_r = 0.
    edge = evaluate.edge_probe_latents(dev)
    hold(f"B={edge.shape[0]} (the edge probe's latents)", edge,
         torch.zeros((edge.shape[0],), device=dev))
    for B in RENDER_CHECK_B:
        latents = env_lib.sample_latents(gen, B, dev)
        latents[: min(B, 2), 4:] = torch.tensor([[0, 0], [31, 31]], device=dev)[: min(B, 2)]
        last_r = torch.rand((B,), generator=gen, device=dev) * 2 - 1
        fixed = torch.tensor([0.0, -1.0, -0.3, 0.4], device=dev)[:B]
        last_r[: fixed.shape[0]] = fixed
        args, err = hold(f"B={B}", latents, last_r)
        if B not in RENDER_TIME_B:
            continue
        kernel = lambda: k_render.render_frames_cuda(lut, *args)
        plain = lambda: k_render.render_frames_plain(lut, *args)
        warm_up_clocks(torch, dev)
        t = {"K1": time_ms(torch, kernel, flush), "plain": time_ms(torch, plain, flush),
             "K1 warm L2": time_ms(torch, kernel),
             "K1 dirty L2": time_ms(torch, kernel, flush_dirty)}
        b2b = time_back_to_back_ms(torch, kernel)
        nbytes = render_bound_bytes(torch, lut, *args[:3])
        bound_ms = nbytes / bw * 1e3
        ms = t["K1"][1]
        # What its own pair of events adds to a call: the same warm call
        # with them less without them.
        events_ms = t["K1 warm L2"][1] - b2b
        k1[B] = dict(max_abs_err=err, ms=ms, plain_ms=t["plain"][1], bound_ms=bound_ms,
                     warm_ms=t["K1 warm L2"][1], back_to_back_warm_ms=b2b,
                     events_ms=events_ms)
        spread = ", ".join(f"{k} {q[1]:.5f} ({q[0]:.5f}-{q[2]:.5f})" for k, q in t.items())
        print(f"[render] B={B}: ms median (quartiles): {spread}; K1 back to back (one event "
              f"pair around {TIMING_REPS} calls, warm L2) {b2b:.5f} per call, so its own "
              f"events add {events_ms:.5f}; bound {bound_ms:.5f} ms "
              f"({nbytes} B at {bw / 1e12:.2f} TB/s): K1 at {bound_ms / ms:.1%} of "
              f"bound, {bound_ms / (ms - events_ms):.1%} less the events [{smi}]", flush=True)
    return k1


def phase_sweep(torch, smi: str, args) -> dict:
    """The main path through the sweep CLI, with launch counts."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.ops.cuda import KERNELS, LAUNCHES

    base = ["--envs", str(SWEEP_ENVS), "--jumps", str(JUMPS), "--steps", "1",
            "--samples", "1", "--seed", "0"]
    sweep_app.main(base + ["--method", "ai", "--macro", "2"])  # warm-up
    runs = {}
    for method in ("ai", "habit"):
        LAUNCHES.clear()
        out = sweep_app.main(base + ["--method", method, "--macro", str(SWEEP_MACRO)])
        launches = dict(LAUNCHES)
        scores = out["scores"]
        check(bool(torch.isfinite(scores).all()), f"{method}: non-finite scores")
        check(tuple(scores.shape) == (SWEEP_ENVS,), f"{method}: scores {tuple(scores.shape)}")
        for name in KERNELS:
            check(launches.get(name, 0) >= 1, f"{method}: kernel {name} never launched")
        check(launches.get("render", 0) == SWEEP_MACRO,
              f"{method}: {launches.get('render', 0)} render launches, want {SWEEP_MACRO}")
        env_steps = SWEEP_ENVS * SWEEP_MACRO * JUMPS / out["wall"]
        g_rows = SWEEP_ENVS * 4 * SWEEP_MACRO / out["wall"] if method == "ai" else 0.0
        runs[method] = dict(launches=launches)
        print(f"[sweep] {method}: {SWEEP_ENVS} envs x {SWEEP_MACRO} macro x {JUMPS} jumps, "
              f"wall {out['wall']:.4f}s, {out['wall'] / SWEEP_MACRO * 1e3:.3f} ms/macro, "
              f"env-steps/s {env_steps:.4e}, G-rows/s {g_rows:.4e}, launches {launches} "
              f"[{smi}]", flush=True)
    if args.profile:
        profile_macro(torch, sweep_app, args.trace_dir)
    return runs


def profile_report(torch, label: str, run, trace_path) -> None:
    """Device time by kernel and by PyTorch op over one call of ``run``
    (torch.profiler), after a warm-up call; the busy share is the device
    time over the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernels and copies only: an annotated region on the device (the
    # optimizer's step) spans kernels that are rows of their own.
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {label} under the profiler: host wall "
          f"{wall_us:.0f} us, device busy {busy_us:.0f} us ({busy_us / wall_us:.1%}), "
          f"{sum(e.count for e in rows)} device ops")
    for e in rows[:20]:
        print(f"[profile]   kernel {e.self_device_time_total:9.0f} us  x{e.count:<4d} "
              f"{e.key[:100]}")
    # The same device time by the PyTorch op that launched it.
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:15]:
        print(f"[profile]   op {e.self_device_time_total:9.0f} us  x{e.count:<4d} {e.key}")
    if trace_path:
        Path(trace_path).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))


def profile_macro(torch, sweep_app, trace_dir) -> None:
    """Two ai macro steps of ``run_sweep`` (the agent and LUT are built
    outside the window)."""
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.train import sweep as sweep_lib

    dev = torch.device("cuda")
    cfg = Config()
    agent = sweep_app.build_agent(cfg, "", dev)
    lut = raster.build_sprite_lut(dev)
    run = lambda: sweep_lib.run_sweep(agent, cfg, lut, seed=0, n_envs=SWEEP_ENVS,
                                      n_macro_steps=2, method="ai", jumps=JUMPS)
    profile_report(torch, f"ai, {SWEEP_ENVS} envs x 2 macro", run,
                   trace_dir and Path(trace_dir) / "ai_macro_trace.json")


def train_config():
    from deep_active_inference_mc_torch.config import Config

    return Config.from_args(TRAIN_FLAGS, batch=TRAIN_BATCH)


def profile_rounds(torch, trace_dir) -> None:
    """Two training rounds at the training phase's batch and flags (state
    and LUT are built outside the window; the window ends in a sync)."""
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
    from deep_active_inference_mc_torch.train import loop as train_loop
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    dev = torch.device("cuda")
    cfg = train_config()
    gen = seeded_generator(dev, 0)
    state = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, dev)
    round_fn = train_loop.make_round_fn(cfg, raster.build_sprite_lut(dev))

    def run():
        for _ in range(2):
            round_fn(state, gen)

    profile_report(torch, f"training, batch {TRAIN_BATCH} x 2 rounds", run,
                   trace_dir and Path(trace_dir) / "train_round_trace.json")


def adam_steps(state) -> dict:
    """Each optimizer's step count (every param of one Adam shares it)."""
    return {k: int(next(iter(opt.state_dict()["state"].values()))["step"])
            for k, opt in state.opts.items()}


def phase_train(torch, smi: str, args) -> dict:
    """The training path through the trainer CLI: train, save, archive,
    resume. Returns K1's launch counts of the two runs."""
    from deep_active_inference_mc_torch.apps import train as train_app
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    repeats = train_config().repeats

    def expected_launches(epochs: int) -> int:
        # The two baseline sweeps, then per epoch: 2 renders per round, the
        # eval pass, the ai and habit sweeps (1 render per macro step).
        per_epoch = 2 * TRAIN_ROUNDS + EVAL_RENDERS + 2 * TRAIN_SWEEP_STEPS
        return 2 * TRAIN_SWEEP_STEPS + epochs * per_epoch

    def check_run(tag, out, launches, epochs):
        for k, series in out["stats"].items():
            check(all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in series),
                  f"{tag}: non-finite stats series {k}")
        got = launches.get("render", 0)
        outside_rounds = expected_launches(epochs) - epochs * 2 * TRAIN_ROUNDS
        per_round = (got - outside_rounds) / (epochs * TRAIN_ROUNDS)
        check(got == expected_launches(epochs),
              f"{tag}: {got} K1 launches, want {expected_launches(epochs)} "
              f"({per_round:.3f} per training round, want 2)")
        for e, sps in enumerate(out["env_steps_per_s"]):
            print(f"[train] {tag} epoch {out['start_epoch'] + e}: "
                  f"{TRAIN_BATCH * repeats / sps * 1e3:.3f} ms/round, train env-steps/s "
                  f"{sps:.4e} (batch {TRAIN_BATCH} x {repeats} repeats x {TRAIN_ROUNDS} "
                  f"rounds / wall) [{smi}]")
        print(f"[train] {tag}: K1 launches {got} = 2 baseline sweeps x {TRAIN_SWEEP_STEPS} + "
              f"{epochs} epoch(s) x (2 x {TRAIN_ROUNDS} rounds + {EVAL_RENDERS} eval + "
              f"2 sweeps x {TRAIN_SWEEP_STEPS}): 2 per training round", flush=True)

    print(f"[train] depth cut: {TRAIN_ROUNDS} rounds per epoch (the flagship run has 1000), "
          f"{TRAIN_EPOCHS}+1 epochs (3000), {TRAIN_SWEEP_STEPS}-step sweeps (100); widths, "
          f"batch {TRAIN_BATCH} and test_size {TRAIN_TEST_SIZE} are the flagship's; PyTorch's "
          f"defaults (cuDNN may use TF32 for float32 convolutions)")
    with tempfile.TemporaryDirectory() as out_root:
        argv = ["--batch", str(TRAIN_BATCH), *TRAIN_FLAGS,
                "--test_size", str(TRAIN_TEST_SIZE), "--sweep_envs", str(TRAIN_SWEEP_ENVS),
                "--rounds", str(TRAIN_ROUNDS), "--sweep_steps", str(TRAIN_SWEEP_STEPS),
                "--save_every", "1", "--archive_every", "2", "--out_root", out_root]
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        first = train_app.main(argv + ["--epochs", str(TRAIN_EPOCHS)])
        launches_first = dict(LAUNCHES)
        check(first["start_epoch"] == 1, f"train: started at epoch {first['start_epoch']}")
        check_run("train", first, launches_first, TRAIN_EPOCHS)
        steps = adam_steps(first["state"])
        check(set(steps.values()) == {TRAIN_EPOCHS * TRAIN_ROUNDS},
              f"train: Adam step counts {steps}")
        archive = first["folder"] / f"checkpoints_epoch_{TRAIN_EPOCHS}" / "state" / "state.pt"
        payload = torch.load(archive, map_location="cpu", weights_only=True)
        check("agent" in payload and "opt_states" not in payload,
              f"archive {archive.name} holds {sorted(payload)}")
        live = torch.load(first["folder"] / "checkpoints" / "state" / "state.pt",
                          map_location="cpu", weights_only=True)
        check("opt_states" in live, "the live checkpoint lacks the optimizer state")

        LAUNCHES.clear()
        resumed = train_app.main(argv + ["--resume", "--epochs", str(TRAIN_EPOCHS + 1)])
        launches_resumed = dict(LAUNCHES)
        check(resumed["start_epoch"] == TRAIN_EPOCHS + 1,
              f"resume: started at epoch {resumed['start_epoch']}, want {TRAIN_EPOCHS + 1}")
        check_run("resume", resumed, launches_resumed, 1)
        steps = adam_steps(resumed["state"])
        check(set(steps.values()) == {(TRAIN_EPOCHS + 1) * TRAIN_ROUNDS},
              f"resume: Adam step counts {steps} do not continue the saved run's")
        peak = torch.cuda.max_memory_allocated()
    nll = resumed["stats"]["mse_o_clean"]
    check(len(nll) == TRAIN_EPOCHS + 1 and all(math.isfinite(v) for v in nll),
          f"mse_o_clean series {nll}")
    check(nll[-1] < nll[0], f"dropout-free pixel NLL did not fall: {nll}")
    print(f"[train] dropout-free pixel NLL by epoch {[round(v, 2) for v in nll]}; Adam steps "
          f"after resume {steps}; archive without optimizer state; peak device memory "
          f"{peak / 2 ** 20:.1f} MiB [{smi}]", flush=True)
    if args.profile:
        profile_rounds(torch, args.trace_dir)
    return {"train": launches_first, "train_resume": launches_resumed}


def card_vs_cpu_inputs(torch):
    """The CPU agent and the injected noise of phase 5 (seeded)."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.infer import efe

    cpu = torch.device("cpu")
    cfg = Config()
    agent = sweep_app.build_agent(cfg, "", cpu)
    g = torch.Generator().manual_seed(4)
    B = CARD_VS_CPU_ENVS
    return agent, dict(
        env=env_lib.randomize(env_lib.reset(g, B, cpu), g),
        rollout=efe.draw_rollout(agent, B, B * 4, g, cpu, steps=1, calc_mean=True,
                                 samples=1, mean_estimator=True),
        g_draws=efe.draw_G(agent, 2 * B, g, cpu, sampled=True),
        s=torch.randn((B, cfg.s_dim), generator=g),
        pi=agent.pi_one_hot[torch.randint(0, 4, (B,), generator=g)],
    )


def forwards(torch, agent, inputs: dict, d) -> dict:
    """Render, every network forward and G on ``d`` (agent already there)."""
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer import efe

    x = to_device(inputs, d)
    with torch.inference_mode():
        o = env_lib.render(raster.build_sprite_lut(d), x["env"])
        mean, logvar = agent.encode(o)
        G4, _, _ = efe.calculate_G_4_repeated(agent, o, steps=1, calc_mean=True, samples=1,
                                              draws=x["rollout"])
        G_s = efe.calculate_G(agent, x["s"], x["pi"], samples=2, draws=x["g_draws"])[0]
        po = agent.decode(x["s"])
        return {
            "frame": o, "enc_mean": mean, "enc_logvar": logvar, "decode": po,
            "transition": agent.transition(x["pi"], x["s"])[0],
            "habit": agent.habit(x["s"])[1], "check_reward": agent.check_reward(po),
            "G4_mean": G4, "G_sampled": G_s,
        }


def phase_card_vs_cpu(torch, dev) -> None:
    agent_cpu, inputs = card_vs_cpu_inputs(torch)
    ref = forwards(torch, agent_cpu, inputs, torch.device("cpu"))
    agent_gpu = type(agent_cpu)().to(dev)
    agent_gpu.load_state_dict(agent_cpu.state_dict())
    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    strict = forwards(torch, agent_gpu, inputs, dev)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    loose = forwards(torch, agent_gpu, inputs, dev)
    for key, want in ref.items():
        tol = G_TOL if key.startswith("G") else NET_TOL
        got = strict[key].cpu()
        ok = torch.allclose(got, want, **tol)
        print(f"[card-vs-cpu] {key} {tuple(want.shape)}: max |diff| "
              f"{(got - want).abs().max().item():.3e} with TF32 off "
              f"(rtol {tol['rtol']} atol {tol['atol']}: {'ok' if ok else 'FAIL'}); "
              f"{(loose[key].cpu() - want).abs().max().item():.3e} with the defaults "
              f"(cuDNN TF32 on)")
        check(ok, f"card-vs-cpu {key} out of tolerance")
    check(torch.equal(strict["frame"].cpu(), ref["frame"]), "K1 frame differs from the CPU's")


def one_round(torch, agent_cpu, cfg, draws, d) -> dict:
    """One training round on ``d`` from ``agent_cpu``'s weights with the
    injected ``draws``: the three losses and gradient norms, as floats."""
    import copy

    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer.precision import PrecisionState
    from deep_active_inference_mc_torch.train import loop as train_loop

    agent = copy.deepcopy(agent_cpu).to(d)
    state = train_loop.TrainState(
        agent, train_loop.make_optimizers(cfg, agent), PrecisionState.create(device=d),
        env_lib.reset(torch.Generator(device=d).manual_seed(0), cfg.batch, d))
    round_fn = train_loop.make_round_fn(cfg, raster.build_sprite_lut(d))
    _, metrics = round_fn(state, draws=to_device(draws, d))
    return {k: float(v) for k, v in metrics.items()}


def phase_round_card_vs_cpu(torch, dev) -> None:
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.train import loop as train_loop

    cpu = torch.device("cpu")
    cfg = Config.from_args(TRAIN_FLAGS, batch=CARD_VS_CPU_ENVS)
    agent = sweep_app.build_agent(cfg, "", cpu)
    draws = train_loop.draw_round(agent, cfg, cfg.batch, torch.Generator().manual_seed(5), cpu)
    ref = one_round(torch, agent, cfg, draws, cpu)
    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    strict = one_round(torch, agent, cfg, draws, dev)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    loose = one_round(torch, agent, cfg, draws, dev)
    rel = lambda got, want: abs(got - want) / max(abs(want), 1e-12)
    for key, rtol in (("F_top", LOSS_RTOL), ("F_mid", LOSS_RTOL), ("F_down", LOSS_RTOL),
                      ("gnorm_top", GNORM_RTOL), ("gnorm_mid", GNORM_RTOL),
                      ("gnorm_down", GNORM_RTOL)):
        ok = rel(strict[key], ref[key]) <= rtol
        print(f"[round card-vs-cpu] {key}: cpu {ref[key]:.6e}, card {strict[key]:.6e} "
              f"(rel diff {rel(strict[key], ref[key]):.3e} with TF32 off, rtol {rtol}: "
              f"{'ok' if ok else 'FAIL'}); rel diff {rel(loose[key], ref[key]):.3e} with the "
              f"defaults (cuDNN TF32 on)")
        check(ok, f"one round, card against CPU: {key} out of tolerance")


def main() -> None:
    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    parser.add_argument("--profile", action="store_true",
                        help="Profile two ai macro steps after the sweep phase and two "
                        "training rounds after the training phase.")
    parser.add_argument("--trace-dir", default="",
                        help="With --profile: write the chrome traces here.")
    args = parser.parse_args()
    if not (ROOT / PACKAGE).is_dir():
        fail(f"{PACKAGE}/ not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    from deep_active_inference_mc_torch.ops.cuda import KERNELS, LAUNCHES, build

    dev = torch.device("cuda")

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    report = build.build(KERNELS)
    print(f"[build] {len(KERNELS)} kernel(s) in {time.perf_counter() - t0:.2f}s")
    for name, r in report.items():
        print(f"[build] {name}: {r['seconds']:.2f}s\n{r['log'].strip()}")
    bw = hbm_bytes_per_s(kind)

    # ---- 2. K1 against its plain version ---------------------------------
    k1 = phase_render(torch, dev, bw, smi)
    LAUNCHES.clear()  # the comparison launches above do not count

    # ---- 3. the serving path at full width -------------------------------
    runs = {f"sweep_{method}": r["launches"] for method, r in
            phase_sweep(torch, smi, args).items()}

    # ---- 4. the training path at full width ------------------------------
    runs.update(phase_train(torch, smi, args))

    # ---- 5. card against CPU ---------------------------------------------
    LAUNCHES.clear()
    phase_card_vs_cpu(torch, dev)
    phase_round_card_vs_cpu(torch, dev)

    # ---- 6. result lines -------------------------------------------------
    # K1's row: the launches of the training run (this system's main path)
    # and the times at its batch; the other paths and sizes beside them.
    for path, launches in runs.items():
        for name in KERNELS:
            check(launches.get(name, 0) >= 1, f"{path}: kernel {name} never launched")
    main_B = TRAIN_BATCH
    kernels = [{
        "name": "render",
        "route": "cuda",
        "source": f"{PACKAGE}/ops/cuda/render.cu",
        "replaces": "deep_active_inference_mc_tpu/ops/pallas/render.py:50",
        "launches": runs["train"].get("render", 0),
        "max_abs_err": k1[main_B]["max_abs_err"],
        "ms": k1[main_B]["ms"],
        "plain_ms": k1[main_B]["plain_ms"],
        "bound_ms": k1[main_B]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "batch": main_B,
        "launches_by_path": {path: launches.get("render", 0)
                             for path, launches in runs.items()},
        "by_batch": {str(B): v for B, v in k1.items()},
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
