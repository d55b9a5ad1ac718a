#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # adds torch.profiler breakdowns of two
                                     # ai macro steps (after phase 3), of two
                                     # training rounds (after phase 4), of
                                     # two planner iterations (after phase 6)
                                     # and of 16 bench env steps (phase 14)
    python3 chip_smoke.py --profile --trace-dir DIR  # and their chrome traces
    python3 chip_smoke.py --ladder   # adds the flagship's ladder rows that take
                                     # minutes each (phase 13); --ladder ROW,ROW
                                     # adds some of them

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name and power limit; build every CUDA kernel
     from this checkout's sources (one nvcc per source, all in parallel).
  2. kernel K1 (frame render) against its plain PyTorch version, bit for
     bit (tolerance 0) at every batch the paths give it (256 and 512
     planner sweeps, 512 training rounds and sweeps, 1000 eval frames, 1024
     sweep envs, 2048 distillation replay rows, and the edge probe's own
     96 latents with no reward shown), at 1, 33 and 4096, and on latents
     off the grid at 1000 and 4096. torch.profiler shows that one
     ``envs.dsprites.render`` is one device kernel (the first design's
     route beside it). At 1 (the demo's batch), 256, 512, 1024, 2048 and
     4096: K1's device time per call with a clean L2 and no events around
     any call (100 x (L2 flush, K1) between one pair of events, less 100
     flushes alone, over 100; the flush reads 128 MB; in turns with K1's
     first design, that design's route (its index math as separate
     launches, then its kernel), the plain version and a same-bytes
     ``copy_`` of the frames, each run paired with a flush run, 3 rounds of
     two), beside K1's time between its own events per call (the method of
     earlier runs) and back to back with a warm L2, and
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
  6. the planner path at full width. (a) Planner mechanics on a
     deterministic mock of the model: the same roots through the plain and
     the bucketed planner on the CPU and on the card, every result field
     and the tree bit-equal (index ops, scatter-add, ties, compaction).
     (b) The sweep CLI's ``main`` with ``--method mcts`` at 256 envs and the
     CLI's defaults (50 repeats, simulation depth 3, max_depth 16), depth
     cut to 3 macro steps: unfused, then ``--mcts_fused``. (c) The behaviour
     ladder's best configuration, ``--mcts_bucketed --plan_queue --mcts_c
     2``, 512 envs, 6 macro steps. (d) One plan at the reference budget (300
     repeats), 256 envs, fused: plain and bucketed. (e) One search on the
     real agent, B = 8, 4 repeats, injected noise, TF32 off, card against
     CPU. Every plan is checked (scores finite, actions in range, lengths
     <= max_depth, repeats_done <= budget); each run prints ms per macro
     step, plans/s, ms per planner iteration, repeats_done, depth_capped,
     peak memory and K1's launches, which must equal the macro steps that
     planned.
  8. MCTS-visit distillation at full width: the distillation CLI on phase
     4's checkpoint at its defaults (256 envs, 100 repeats, expand_k 4,
     fused, batch 2048, 4 passes), depth cut to 2 iterations of 8
     decisions (2048 records: one 2048-row replay step per pass) and
     10-step habit readouts on 512 envs. Checks: every plan, mid and down
     and their Adams bit-equal to the checkpoint's, the top Adam at 4 steps
     per iteration, K1's launches = 8 per collect + 4 per iteration + one
     per readout macro step. Prints ms per collect, plans/s of the collect,
     ms per replay step and peak memory. Then the trainer with
     ``--distill_every 1 --distill_macro 2`` for one epoch: the phase runs
     before the save and fills the distill series.
  9. the demo: ``--headless 100`` (one round) on the distilled checkpoint
     for ``habit``, ``ai`` (7 steps, 10 samples) and ``mcts`` (300
     repeats, depth 3). Checks: a finite score trace, K1's launches = the
     plans made. Prints frames/s and plans per round.
 10. the causal trainer CLI at batch 512 (test size 1000, 20 rounds, 2
     epochs, then ``--resume`` for a third). Checks: finite stats, F
     falling from epoch 1 to 3, 2 K1 launches per round and 2 per eval,
     the figures drawn every epoch. Prints ms per round and peak memory.
 11. bf16 forwards at full width: the sweep CLI ``--bf16 --method ai`` at
     1024 envs, 20 macro steps (ms/macro beside phase 3's float32); the
     trainer ``--bf16`` at batch 512 with the flagship's flags, two epochs
     of 20 rounds (ms/round beside phase 4's); ``--method mcts --mcts_fused
     --bf16`` at 256 envs, 3 macro steps; one distillation iteration with
     ``--bf16`` on phase 4's checkpoint. Checks: finite scores, stats and
     metrics, K1's launches, the planner's G terms float32; prints the
     card's bf16 shift from its float32 in G and in one round's losses (TF32
     off) and the peak memory of each run.
 12. multi-device: R = the cards (at most 4), or 2 ranks sharing one card
     over gloo. The trainer CLI ``--mesh_shape R`` at batch 512 with the
     flagship's flags, one epoch of 20 rounds, saved, then resumed on one
     rank for a second epoch; ``--mesh_shape R --tp 2`` for one epoch of 10
     rounds; one injected-noise round at batch 8 and at 512 on R ranks (data
     parallel, then tensor parallel) against one rank, TF32 off, to
     tests/test_parallel.py's tolerances up to Adam's sign steps;
     the sweep CLI ``--mesh R`` (ai, 1024 envs) against phase 3's scores;
     two trainer processes meeting at ``--coordinator 127.0.0.1:<port>``
     as hosts 0 and 1. Prints the backend, the ranks, the cards, ms/round
     by rank and K1's launches per rank, which must be 2 per round.
 13. the flagship: the committed trained agent
     (``artifacts/run512/checkpoints``, read through its ``torch_export.npz``)
     through the CLIs' ``main``s with ``-n`` / ``--resume``. (a) The weights
     on the card equal the export bit for bit. (b) The habit net's P(up) at
     the scoring edge sorts squares left and the others right (the
     contrast contract of tests/test_trained_artifact.py). (c) Ladder rows
     at the committed protocol (seed 0, 200 macro steps, 5 jumps):
     ``random``, ``expert`` and ``habit`` at 4096 envs, ``ai`` (2 steps) at
     1024 envs with TF32 off and with PyTorch's defaults; each within 4
     sigma (combined) of ``artifacts/run512/eval_log_round5.txt``.
     ``--ladder`` adds ``ai`` at 4096 envs (TF32 off and on),
     ``mcts_c2+queue`` at 256 envs and ``mcts_c2_bucketed+queue`` at 512.
     (d) One plan at the reference budget (300 repeats, fused, float32) at
     256 envs, plain and bucketed: ``repeats_done`` beside the JAX
     package's, at least one compaction; then ``--mcts_bucketed
     --plan_queue --mcts_c 2`` (300 repeats, fused, bf16) at 512 envs, 6
     macro steps (depth cut from 200), every plan checked. (e) The
     trainer ``--resume`` from a copy of the store with the run's
     ``config.json`` flags (batch 512, ``freeze_top``), one epoch of 20
     rounds: it starts at epoch 1300,
     fresh Adams, ``top`` bit-unchanged, MSEo within 0.85-1.25 x the run's
     last 10 epochs' median, K1 twice per round. (f) One distillation
     iteration (2 decisions) and one headless demo round per controller.
 14. the benchmark harness (``deep_active_inference_mc_torch/bench.py``):
     every key of ``python -m deep_active_inference_mc_torch.bench`` through
     its ``bench_*`` function at full width and with ``main``'s arguments,
     each MCTS, bucketed and training key cut to one timed run after its
     warm-ups (env steps at 4096 envs and G at 1024 x 4 rows uncut). Checks:
     every rate finite and positive, every plan, the trained keys present,
     K1 launched once per env step (256 x (1 + 3)) and twice per training
     round. Prints each key's rate, wall and peak memory, then one line of
     the readings.
 15. one JSON line describing every hand-written kernel, the card's
     ``nvidia-smi`` name and power limit, and the result line
     ``{"ok": true, "device": {...}}`` last. Imports nothing of JAX.

From phase 4 on, the port's figure functions (``viz/``) are recorders: the
card's machine has no matplotlib, PIL or scikit-learn. Each
recorder checks what it is given (finite arrays of the right shapes, frames
in [0, 1], the traversal's decoder on the card) and counts its calls.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pickle
import shutil
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
CLEAN_L2_ROUNDS = 3  # each timed in turns twice per round
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
# The planner phase: the sweep CLI's MCTS defaults, depth cut.
MCTS_ENVS = 256
MCTS_MACRO = 3  # the CLI's default is 100
MCTS_REPEATS, MCTS_MAX_DEPTH = 50, 16  # the CLI's defaults
LADDER_ENVS, LADDER_MACRO = 512, 6  # artifacts/run512/eval_log_round5.txt's best row
REF_BUDGET = 300  # the reference's repeats
SEARCH_REPEATS = 4  # the card-against-CPU search
PROB_MARGIN = 1e-2  # a selection argmax is compared only above this top-two gap
# K1 is held to its plain version at every batch the two paths give it
# (the edge probe's 96 rows are a case of their own in phase_render) and at
# a 1-env, an odd and a large one; timed where a path spends its launches.
# The distillation phase: the CLI's defaults (256 envs, 100 repeats, expand_k
# 4, batch 2048, 4 passes), depth cut.
DISTILL_ITERS = 2  # the CLI's default is 20
DISTILL_MACRO = 8  # 40: 8 x 256 = 2048 records, one 2048-row replay step per pass
DISTILL_SWEEP_STEPS = 10  # the readout's default is 100
DISTILL_BATCH = 2048
DEMO_REPEATS = 300  # the demo's default
RENDER_CHECK_B = sorted({1, 33, MCTS_ENVS, TRAIN_BATCH, TRAIN_SWEEP_ENVS, LADDER_ENVS,
                         TRAIN_TEST_SIZE, SWEEP_ENVS, DISTILL_BATCH, 4096})
# B=1: the timing method's floor and the demo's batch.
RENDER_TIME_B = (1, MCTS_ENVS, TRAIN_BATCH, SWEEP_ENVS, DISTILL_BATCH, 4096)
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
    """(25th, 50th, 75th) percentile device time of one call of ``fn``, each
    call between its own pair of CUDA events (the method of earlier runs,
    kept so that their numbers stay comparable). All calls are enqueued
    while a sleep kernel holds the card, so no call waits on the host;
    ``flush`` (if given) runs before each call, outside the events. Two
    such passes run and the first is discarded: its window was seen to be
    disturbed (wide quartiles) while the second's is not."""
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


def time_run_ms(torch, fn, reps: int) -> float:
    """Device time of ``reps`` calls of ``fn`` between ONE pair of events,
    queued behind a sleep kernel so that no call waits on the host."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_back_to_back_ms(torch, fn, reps: int = TIMING_REPS, passes: int = 5) -> float:
    """Device time per call of ``reps`` calls of ``fn`` back to back inside
    one pair of events, the L2 warm (median of ``passes`` runs after a
    discarded one)."""
    return statistics.median([time_run_ms(torch, fn, reps) / reps
                              for _ in range(passes + 1)][1:])


def time_clean_l2_ms(torch, fns: dict, flush, reps: int = TIMING_REPS,
                     rounds: int = CLEAN_L2_ROUNDS) -> dict:
    """Device time per call of each of ``fns`` with a clean L2 and no event
    beside any call: ``reps`` x (flush, fn) between one pair of events, less
    ``reps`` x flush alone, over ``reps``. The runs go in turns, the order
    reversed every round (a b c flush, flush c b a, ...), and each fn's
    i-th run is paired with the flush's i-th. Returns per name (min,
    median, max) over the pairs."""
    runs = {name: [] for name in [*fns, "flush"]}
    order = list(runs)
    for i in range(2 * rounds):
        for name in (order if i % 2 == 0 else order[::-1]):
            fn = fns.get(name)
            step = flush if fn is None else (lambda fn=fn: (flush(), fn()))
            runs[name].append(time_run_ms(torch, step, reps))
    out = {}
    for name in fns:
        per_call = [(t - f) / reps for t, f in zip(runs[name], runs["flush"])]
        out[name] = (min(per_call), statistics.median(per_call), max(per_call))
    return out


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


def render_bound_bytes(torch, lut, latents) -> int:
    """Bytes K1 must move for these inputs: each LUT pixel that some
    window covers read once, 40 B of latents (columns 1-5) and 4 B of
    last_r per env, each frame written once."""
    from deep_active_inference_mc_torch.envs import raster

    idx, r0, c0 = raster.clamp_windows(raster.sprite_index(latents),
                                       *raster.window_offsets(latents))
    used = torch.zeros(lut.shape, dtype=torch.bool, device=lut.device)
    ar = torch.arange(raster.RES, device=lut.device)
    used[idx[:, None, None], (r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]] = True
    B = latents.shape[0]
    return 4 * int(used.sum()) + 44 * B + 4 * B * raster.RES ** 2


def first_design(torch, lut, latents, last_r):
    """(launch, route): K1's first design (``render.cu``'s
    ``daimc_render_frames_first_design``), which no path runs any more.
    ``launch`` runs its kernel alone on int32 sprite index and offsets
    computed here once; ``route`` also computes them first, as separate
    launches, as that design's renders did."""
    import ctypes

    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import build
    from deep_active_inference_mc_torch.ops.cuda import render as k_render

    fn = build.load(k_render.NAME).daimc_render_frames_first_design
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def inputs():
        row0, col0 = raster.window_offsets(latents)
        return (raster.sprite_index(latents).to(torch.int32).contiguous(),
                row0.to(torch.int32).contiguous(), col0.to(torch.int32).contiguous(),
                last_r.to(torch.float32).contiguous())

    B = latents.shape[0]
    fixed = inputs()

    def launch(args=fixed):
        out = torch.empty((B, 1, raster.RES, raster.RES), dtype=torch.float32, device=lut.device)
        err = fn(lut.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(), B,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"K1's first design: launch failed, cudaError_t {err}")
        return out

    return launch, lambda: launch(inputs())


def device_kernels(torch, fn) -> list:
    """(name, count) of every device kernel that one call of ``fn`` ran,
    from torch.profiler (after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def phase_render(torch, dev, bw: float, smi: str) -> tuple:
    """K1 against its plain version; launches per render; times and bound
    at the timed sizes. Returns ({B: K1's numbers}, device kernels in one
    render)."""
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import render as k_render
    from deep_active_inference_mc_torch.train import evaluate

    gen = torch.Generator(device=dev).manual_seed(1)
    lut = raster.build_sprite_lut(dev)
    # Evicting the L2 by reading a larger buffer leaves it clean: K1 then
    # reads the LUT from HBM, as after the network passes on the main path.
    l2 = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = l2.sum
    k1 = {}

    def hold(label, latents, last_r):
        """K1 == plain on these inputs; returns max |diff|."""
        got = k_render.render_frames_cuda(lut, latents, last_r)
        want = k_render.render_frames_plain(lut, latents, last_r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        check(torch.equal(got, want), f"K1 differs from its plain version at {label}: "
              f"max |diff| {err}")
        print(f"[render] {label}: K1 == plain, bit for bit (tolerance 0, max_abs_err {err})")
        return err

    # The eval pass's edge probe: 96 rows at posY=31, last_r = 0.
    edge = evaluate.edge_probe_latents(dev)
    hold(f"B={edge.shape[0]} (the edge probe's latents)", edge,
         torch.zeros((edge.shape[0],), device=dev))
    # Off the grid: offsets beyond 32 and below 0, sprites beyond 719 and
    # below 0, clamped as XLA clamps them.
    for B in (1000, 4096):
        off = env_lib.sample_latents(gen, B, dev)
        off[:, 1:] += torch.randint(-200, 200, (B, 5), generator=gen, device=dev)
        hold(f"B={B} (latents off the grid)", off,
             torch.rand((B,), generator=gen, device=dev) * 2 - 1)

    # One render on the main path is one launch; the first design's was more.
    state = env_lib.randomize(env_lib.reset(gen, TRAIN_BATCH, dev), gen)
    route = device_kernels(torch, lambda: env_lib.render(lut, state))
    _, first_route = first_design(torch, lut, state.latents, state.last_r)
    n_first = sum(c for _, c in device_kernels(torch, first_route))
    n_route = sum(c for _, c in route)
    check(n_route == 1 and "render_frames_tma" in route[0][0],
          f"one envs.dsprites.render ran {route} on the device, want K1 alone")
    print(f"[render] one envs.dsprites.render at B={TRAIN_BATCH}: {n_route} device kernel "
          f"({route[0][0]}); the first design's route: {n_first} (torch.profiler)", flush=True)

    for B in RENDER_CHECK_B:
        latents = env_lib.sample_latents(gen, B, dev)
        latents[: min(B, 2), 4:] = torch.tensor([[0, 0], [31, 31]], device=dev)[: min(B, 2)]
        last_r = torch.rand((B,), generator=gen, device=dev) * 2 - 1
        fixed = torch.tensor([0.0, -1.0, -0.3, 0.4], device=dev)[:B]
        last_r[: fixed.shape[0]] = fixed
        err = hold(f"B={B}", latents, last_r)
        if B not in RENDER_TIME_B:
            continue
        kernel = lambda: k_render.render_frames_cuda(lut, latents, last_r)
        plain = lambda: k_render.render_frames_plain(lut, latents, last_r)
        first, first_route = first_design(torch, lut, latents, last_r)
        check(torch.equal(first(), plain()), f"K1's first design differs at B={B}")
        frames, copy_dst = kernel(), torch.empty((B, 1, raster.RES, raster.RES), device=dev)
        copy = lambda: copy_dst.copy_(frames)
        warm_up_clocks(torch, dev)
        # K1 and its first design in turns (new, first, first, new, ...).
        t = time_clean_l2_ms(torch, {"K1": kernel, "first design": first,
                                     "its route": first_route, "plain": plain, "copy_": copy},
                             flush)
        events = time_ms(torch, kernel, flush)
        b2b = time_back_to_back_ms(torch, kernel)
        nbytes = render_bound_bytes(torch, lut, latents)
        bound_ms = nbytes / bw * 1e3
        ms = t["K1"][1]
        k1[B] = dict(max_abs_err=err, ms=ms, first_design_ms=t["first design"][1],
                     first_design_route_ms=t["its route"][1],
                     plain_ms=t["plain"][1], copy_ms=t["copy_"][1], bound_ms=bound_ms,
                     bound_bytes=nbytes, per_call_events_ms=events[1],
                     back_to_back_warm_ms=b2b)
        spread = ", ".join(f"{k} {q[1]:.5f} ({q[0]:.5f}-{q[2]:.5f})" for k, q in t.items())
        print(f"[render] B={B}: clean L2, no events, ms per call median (min-max of "
              f"{2 * CLEAN_L2_ROUNDS} runs of {TIMING_REPS}): {spread}; K1 between its own events "
              f"{events[1]:.5f} ({events[0]:.5f}-{events[2]:.5f}); K1 back to back, warm L2 "
              f"{b2b:.5f}; bound {bound_ms:.5f} ms ({nbytes} B at {bw / 1e12:.2f} TB/s): K1 "
              f"at {bound_ms / ms:.1%} of bound, its first design at "
              f"{bound_ms / t['first design'][1]:.1%}, copy_ at {bound_ms / t['copy_'][1]:.1%} "
              f"[{smi}]", flush=True)
    return k1, n_route


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
        runs[method] = dict(launches=launches, scores=scores.cpu(),
                            ms_macro=out["wall"] / SWEEP_MACRO * 1e3)
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


def phase_train(torch, smi: str, args, out_root: str) -> dict:
    """The training path through the trainer CLI: train, save, archive,
    resume, into ``out_root``. Returns K1's launch counts of the two runs
    and the run folder."""
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
    ms_round = [round(TRAIN_BATCH * repeats / sps * 1e3, 3) for sps in first["env_steps_per_s"]]
    return ({"train": launches_first, "train_resume": launches_resumed}, resumed["folder"],
            ms_round)


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


# ------------------------------------------------------------ the planner
class MockPlannerModel:
    """A deterministic stand-in for the agent and the two G functions the
    planner calls, in arithmetic that rounds the same on the CPU and on the
    card: elementwise products, sums taken term by term, divisions, table
    look-ups. G depends on state and action; the next state drifts by
    action. With ``ties`` every action of a node has the same G, so every
    argmax of a walk meets an exact tie."""

    pi_dim = 4
    S_DIM = 6

    def __init__(self, torch, device, ties: bool = False):
        self.torch = torch
        self.pi_one_hot = torch.eye(self.pi_dim, device=device)
        self.w_G = [-0.5 + 1.3 * j / (self.S_DIM - 1) for j in range(self.S_DIM)]
        # The tables are made on the CPU and moved, as weights are: a card
        # divides a tensor by a number by multiplying with its reciprocal.
        self.c_A = torch.tensor([0.0] * 4 if ties else [0.3, -0.2, 0.05, -0.4]).to(device)
        self.d_A = (torch.arange(4.0 * self.S_DIM).reshape(4, self.S_DIM)
                    / (4 * self.S_DIM) - 0.4).to(device)

    @staticmethod
    def _sum(terms):
        total = terms[0]
        for x in terms[1:]:
            total = total + x
        return total

    def encode(self, frames):  # "frames" are already states
        return frames, None

    def _q_pi(self, s):
        q = s[:, :self.pi_dim] * s[:, :self.pi_dim] + 0.1
        return q / self._sum([q[:, j] for j in range(self.pi_dim)])[:, None]

    def habit(self, s):
        q = self._q_pi(s)
        return None, q, self.torch.log(q + 1e-20)

    def calculate_G_mean(self, agent, s0, pi0, generator=None, draws=None):
        a = pi0.argmax(dim=-1)
        G = self._sum([s0[:, j] * self.w_G[j] for j in range(self.S_DIM)]) + self.c_A[a]
        return G, None, s0 * 0.9 + self.d_A[a], None

    def mcts_step_simulate(self, agent, leaf_s, depth, use_means=False, generator=None,
                           draws=None):
        G = self._sum([leaf_s[:, j] for j in range(self.S_DIM)]) * 0.7
        return G, None, self._q_pi(leaf_s)


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of ``obj`` for the block, then put the old ones back."""
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


RESULT_FIELDS = ("actions", "lengths", "repeats_done", "states_explored", "depth_capped",
                 "root_N", "root_Qpi")
TREE_FIELDS = ("s", "W", "N", "Qpi", "children", "done", "repeats_done", "states_explored",
               "depth_capped")

# name: (MCTSParams fields, envs, check_every, min_bucket, ties)
MECHANICS_CASES = {
    "compaction": (dict(repeats=24, threshold=0.3, max_depth=16), 64, 2, 4, False),
    "prior": (dict(repeats=24, threshold=0.28, max_depth=16,
                   using_prior_for_exploration=True), 64, 2, 4, False),
    "depth_cap": (dict(repeats=14, threshold=1.1, C=0.01, max_depth=3), 16, 4, 4, False),
    "expand_k2": (dict(repeats=24, threshold=0.2, max_depth=16, expand_k=2), 64, 2, 4, False),
    "ties": (dict(repeats=8, threshold=10.0, max_depth=16), 8, 2, 4, True),
}


def phase_planner_mechanics(torch, dev) -> None:
    """The plain and the bucketed planner on the mock model, card against
    CPU: every result field, the tree and the bucket traces equal."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    for name, (fields, B, check_every, min_bucket, ties) in MECHANICS_CASES.items():
        p = mcts_lib.MCTSParams(**fields)
        roots = torch.randn((B, MockPlannerModel.S_DIM),
                            generator=torch.Generator().manual_seed(3)) * 0.5
        if ties:
            roots = torch.zeros_like(roots)
        runs = {}
        for d in (torch.device("cpu"), dev):
            model = MockPlannerModel(torch, d, ties)
            with patched(mcts_lib.efe, calculate_G_mean=model.calculate_G_mean,
                         mcts_step_simulate=model.mcts_step_simulate):
                if ties:
                    # Every root edge has the same W and N: the walk's first
                    # argmax must take the first maximum, action 0 into slot 1.
                    tree = mcts_lib._init_search(model, roots.to(d), p, (7,)).tree
                    _, acts, _, leaf = mcts_lib._select(tree, p.C, False, p.max_depth)
                    check(bool((tree.W[:, 0] == tree.W[:, 0, :1]).all()),
                          "planner mechanics: the ties case has no tie at the root")
                    check(bool((acts[:, 0] == 0).all() and (leaf == 1).all()),
                          f"planner mechanics: argmax on {d.type} did not take the first of "
                          f"tied maxima")
                plain = mcts_lib.active_inference_mcts(model, roots.to(d), p, (7,),
                                                       return_tree=True)
                plan = mcts_lib.make_bucketed_planner(model, p, check_every, min_bucket)
                bucketed = plan(roots.to(d), (7,))
            runs[d.type] = (plain, bucketed, list(plan.bucket_trace), list(plan.schedule))
        cpu_plain, cpu_bucketed, cpu_trace, cpu_schedule = runs["cpu"]
        plain, bucketed, trace, schedule = runs[dev.type]
        for f in RESULT_FIELDS:
            want = getattr(cpu_plain, f)
            for label, got in (("card plain", getattr(plain, f)),
                               ("card bucketed", getattr(bucketed, f)),
                               ("cpu bucketed", getattr(cpu_bucketed, f))):
                check(torch.equal(got.cpu(), want),
                      f"planner mechanics {name}: {label} {f} differs from the CPU's plain")
        for f in TREE_FIELDS:
            check(torch.equal(getattr(plain.tree, f).cpu(), getattr(cpu_plain.tree, f)),
                  f"planner mechanics {name}: the card's tree.{f} differs from the CPU's")
        check(trace == cpu_trace and schedule == cpu_schedule,
              f"planner mechanics {name}: bucket trace {trace} at {schedule} on the card, "
              f"{cpu_trace} at {cpu_schedule} on the CPU")
        if name in ("compaction", "prior", "expand_k2"):
            check(len(trace) > 1, f"planner mechanics {name}: no compaction fired ({trace})")
        if name == "depth_cap":
            check(int(plain.depth_capped.sum()) > 0, "planner mechanics: no walk hit the cap")
        reps = cpu_plain.repeats_done
        print(f"[planner mechanics] {name}: {B} envs, card == CPU and bucketed == plain in "
              f"{len(RESULT_FIELDS)} result fields and {len(TREE_FIELDS)} tree fields, bit for "
              f"bit; repeats_done {int(reps.min())}-{int(reps.max())}, depth_capped "
              f"{int(cpu_plain.depth_capped.sum())}, buckets {trace} at iterations {schedule}",
              flush=True)


def check_plan(torch, tag: str, res, p) -> None:
    """The checks every planner result must pass."""
    n_iters = -(-p.repeats // p.expand_k)
    acts = res.actions
    check(tuple(acts.shape[1:]) == (p.max_depth,), f"{tag}: actions {tuple(acts.shape)}")
    check(bool(((acts >= -1) & (acts < 4)).all()), f"{tag}: an action outside [-1, 4)")
    check(bool(((res.lengths >= 0) & (res.lengths <= p.max_depth)).all()),
          f"{tag}: a path longer than max_depth")
    padded = torch.arange(p.max_depth, device=acts.device)[None, :] >= res.lengths[:, None]
    check(bool(((acts == -1) == padded).all()), f"{tag}: padding does not follow the lengths")
    check(bool(((res.repeats_done >= 0) & (res.repeats_done <= n_iters * p.expand_k)).all()),
          f"{tag}: repeats_done beyond the budget")
    check(bool(torch.isfinite(res.root_N).all() and torch.isfinite(res.root_Qpi).all()),
          f"{tag}: non-finite root statistics")
    check(bool((res.root_N.sum(dim=-1) >= 4).all()), f"{tag}: a root that was not expanded")


@contextlib.contextmanager
def recorded_plans(torch, log: list):
    """While the block runs, every plan of the port's two planners is
    checked and appended to ``log`` as (envs, seconds, result, buckets);
    the seconds are host time around the plan, synchronized on both sides."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    def timed(plan, p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_plan(torch, f"plan {len(log)}", res, p)
        return res, dt

    plain = mcts_lib.active_inference_mcts
    make_bucketed = mcts_lib.make_bucketed_planner

    def plain_recorded(agent, frames, p, *a, **kw):
        res, dt = timed(lambda: plain(agent, frames, p, *a, **kw), p)
        log.append((frames.shape[0], dt, res, None))
        return res

    class BucketedRecorded:
        def __init__(self, agent, p, *a, **kw):
            self._plan, self._p = make_bucketed(agent, p, *a, **kw), p

        def __call__(self, frames, seed_path):
            res, dt = timed(lambda: self._plan(frames, seed_path), self._p)
            log.append((frames.shape[0], dt, res, list(self._plan.bucket_trace)))
            return res

        def __getattr__(self, name):  # bucket_trace, schedule
            return getattr(self._plan, name)

    with patched(mcts_lib, active_inference_mcts=plain_recorded,
                 make_bucketed_planner=BucketedRecorded):
        yield


def report_plans(torch, tag: str, log: list, envs: int, macro: int, wall: float, launches: dict,
                 smi: str, repeats: int = MCTS_REPEATS) -> None:
    reps = torch.cat([r.repeats_done for _, _, r, _ in log]).double()
    capped = sum(int(r.depth_capped.sum()) for _, _, r, _ in log)
    lengths = torch.cat([r.lengths for _, _, r, _ in log]).double()
    plan_s = sum(dt for _, dt, _, _ in log)
    # A plan runs until its slowest env decides (one iteration more, to see it).
    iters = sum(min(int(r.repeats_done.max()) + 1, repeats) for _, _, r, _ in log)
    rows = sum(B for B, _, _, _ in log)
    print(f"[mcts] {tag}: {envs} envs x {macro} macro, wall {wall:.4f}s, "
          f"{wall / macro * 1e3:.2f} ms/macro, plans/s (envs x macro / wall) "
          f"{envs * macro / wall:.2f}; {len(log)} planner calls over {rows} rows in "
          f"{plan_s:.4f}s, {plan_s / iters * 1e3:.3f} ms per planner iteration ({iters} "
          f"iterations); repeats_done mean {reps.mean():.2f} max {int(reps.max())}, "
          f"depth_capped total {capped}, plan length mean {lengths.mean():.2f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, launches {launches} "
          f"[{smi}]", flush=True)
    traces = [tr for _, _, _, tr in log if tr is not None]
    if traces:
        print(f"[mcts] {tag}: bucket traces {traces}", flush=True)


def phase_mcts_sweeps(torch, smi: str) -> dict:
    """The planner path through the sweep CLI: unfused, fused, and the
    ladder's bucketed + queue configuration. Returns K1's launch counts."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    mcts = ["--method", "mcts", "--jumps", str(JUMPS), "--seed", "0"]
    runs = {
        "mcts": (MCTS_ENVS, MCTS_MACRO, []),
        "mcts_fused": (MCTS_ENVS, MCTS_MACRO, ["--mcts_fused"]),
        "mcts_bucketed_queue": (LADDER_ENVS, LADDER_MACRO,
                                ["--mcts_bucketed", "--plan_queue", "--mcts_c", "2"]),
    }
    print(f"[mcts] depth cut: {MCTS_MACRO} and {LADDER_MACRO} macro steps (the CLI's default "
          f"is 100); the widths, {MCTS_REPEATS} repeats, simulation depth 3 and max_depth "
          f"{MCTS_MAX_DEPTH} are the CLI's defaults; seeded init, PyTorch's defaults")
    # Warm-up: cuDNN picks its algorithms for the planner's batch shapes.
    sweep_app.main(mcts + ["--envs", str(MCTS_ENVS), "--macro", "1", "--mcts_repeats", "2"])
    out_launches = {}
    for tag, (envs, macro, flags) in runs.items():
        log = []
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        with recorded_plans(torch, log):
            out = sweep_app.main(mcts + ["--envs", str(envs), "--macro", str(macro)] + flags)
        launches = dict(LAUNCHES)
        check(bool(torch.isfinite(out["scores"]).all()), f"{tag}: non-finite scores")
        check(tuple(out["scores"].shape) == (envs,), f"{tag}: scores {tuple(out['scores'].shape)}")
        # K1 renders once per macro step that planned; only the queued
        # bucketed sweep can skip a step (no env's queue ran out).
        want = len(log)
        check(want == macro or "--plan_queue" in flags, f"{tag}: {want} plans, {macro} macro")
        check(1 <= want <= macro, f"{tag}: {want} plans in {macro} macro steps")
        check(launches.get("render", 0) == want,
              f"{tag}: {launches.get('render', 0)} K1 launches, want {want} (the macro steps "
              f"in which some env needed a plan)")
        if "bucket_traces" in out:
            check(out["bucket_traces"] == [tr for _, _, _, tr in log],
                  f"{tag}: the sweep's bucket traces are not the planner's")
        report_plans(torch, tag, log, envs, macro, out["wall"], launches, smi)
        out_launches[f"sweep_{tag}"] = launches
    return out_launches


def planner_inputs(torch, dev, envs: int):
    """(agent, frames) at full width on ``dev``: seeded init, rendered
    frames of ``envs`` seeded random envs."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster

    agent = sweep_app.build_agent(Config(), "", dev)
    g = torch.Generator(device=dev).manual_seed(6)
    env = env_lib.randomize(env_lib.reset(g, envs, dev), g)
    with torch.inference_mode():
        return agent, env_lib.render(raster.build_sprite_lut(dev), env)


def phase_reference_budget(torch, dev, smi: str) -> None:
    """One plan at the reference's budget, fused: plain and bucketed.
    Printed, not asserted beyond the per-plan checks."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    agent, frames = planner_inputs(torch, dev, MCTS_ENVS)
    p = mcts_lib.MCTSParams(repeats=REF_BUDGET, simulation_depth=3, max_depth=MCTS_MAX_DEPTH,
                            fused_eval=True)
    bucketed = mcts_lib.make_bucketed_planner(agent, p)  # the CLI's cadence: 16, 32
    planners = {"plain": lambda: mcts_lib.active_inference_mcts(agent, frames, p, (0,)),
                "bucketed": lambda: bucketed(frames, (0,))}
    for tag, plan in planners.items():
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_plan(torch, f"reference budget, {tag}", res, p)
        reps = res.repeats_done.double()
        trace = f", buckets {bucketed.bucket_trace} at {bucketed.schedule}" if tag == "bucketed" \
            else ""
        print(f"[mcts] reference budget ({REF_BUDGET} repeats, fused, float32), {tag}: "
              f"{MCTS_ENVS} envs, one plan in {dt:.4f}s, plans/s {MCTS_ENVS / dt:.2f}, "
              f"{dt / min(int(reps.max()) + 1, REF_BUDGET) * 1e3:.3f} ms per iteration; "
              f"repeats_done mean {reps.mean():.2f} max {int(reps.max())}, depth_capped total "
              f"{int(res.depth_capped.sum())}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB{trace} [{smi}]", flush=True)


def phase_search_card_vs_cpu(torch, dev) -> None:
    """One whole search on the real agent with injected noise, card
    against CPU, TF32 off. An env's integers are compared only if every
    argmax its selection walks took on the CPU had a top-two gap above
    PROB_MARGIN, which a G difference within tolerance cannot bridge."""
    from deep_active_inference_mc_torch.infer import efe
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    cpu = torch.device("cpu")
    B = CARD_VS_CPU_ENVS
    agent_cpu, frames = planner_inputs(torch, cpu, B)
    p = mcts_lib.MCTSParams(repeats=SEARCH_REPEATS, simulation_depth=3,
                            max_depth=MCTS_MAX_DEPTH, threshold=0.9)
    g = torch.Generator().manual_seed(8)
    draws = mcts_lib.SearchDraws(
        efe.draw_G(agent_cpu, B * 4, g, cpu, sampled=False),
        [mcts_lib.IterationDraws(expand=efe.draw_G(agent_cpu, B * 4, g, cpu, sampled=False),
                                 simulate=efe.draw_simulate(agent_cpu, B, p.simulation_depth,
                                                            g, cpu))
         for _ in range(p.repeats)])

    # The CPU's search, step by step, noting which envs' walks were clear.
    clear = torch.ones(B, dtype=torch.bool)
    bidx = torch.arange(B)
    with torch.inference_mode():
        carry = mcts_lib._init_search(agent_cpu, frames, p, None, draws)
        for i in range(p.repeats):
            nodes, _, _, _ = mcts_lib._select(carry.tree, p.C, False, p.max_depth)
            for d in range(p.max_depth):
                at = nodes[:, d].clamp(min=0)
                top = mcts_lib._probs_for_selection(
                    carry.tree.W[bidx, at], carry.tree.N[bidx, at], carry.tree.Qpi[bidx, at],
                    p.C, False).topk(2).values
                clear &= (nodes[:, d] < 0) | (top[:, 0] - top[:, 1] > PROB_MARGIN)
            mcts_lib._run_search(agent_cpu, carry, p, i + 1, draws=draws.iterations)
        want = mcts_lib._finalize_search(agent_cpu, carry, p)
    want_tree = carry.tree

    agent_gpu = type(agent_cpu)().to(dev)
    agent_gpu.load_state_dict(agent_cpu.state_dict())
    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    got = mcts_lib.active_inference_mcts(agent_gpu, frames.to(dev), p,
                                         draws=to_device(draws, dev), return_tree=True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    check_plan(torch, "search card-vs-cpu", got, p)
    check(int(clear.sum()) >= B // 2, f"search card-vs-cpu: only {int(clear.sum())} of {B} "
          f"envs have every selection gap above {PROB_MARGIN}")
    w_tol = dict(rtol=G_TOL["rtol"], atol=G_TOL["atol"] * (p.repeats + 1))
    w_err = (got.tree.W.cpu() - want_tree.W)[clear].abs().max().item()
    for f in ("children", "N"):
        check(torch.equal(getattr(got.tree, f).cpu()[clear], getattr(want_tree, f)[clear]),
              f"search card-vs-cpu: tree.{f} differs on an env with clear gaps")
    check(torch.allclose(got.tree.W.cpu()[clear], want_tree.W[clear], **w_tol),
          f"search card-vs-cpu: W max |diff| {w_err}")
    check(torch.allclose(got.root_N.cpu()[clear], want.root_N[clear], **G_TOL),
          "search card-vs-cpu: root_N out of tolerance")
    check(torch.allclose(got.root_Qpi.cpu(), want.root_Qpi, **NET_TOL),
          "search card-vs-cpu: root_Qpi out of tolerance")
    for f in ("actions", "lengths", "repeats_done", "states_explored", "depth_capped"):
        check(torch.equal(getattr(got, f).cpu()[clear], getattr(want, f)[clear]),
              f"search card-vs-cpu: {f} differs on an env with clear gaps")
    print(f"[search card-vs-cpu] B={B}, {p.repeats} iterations, injected noise, TF32 off: "
          f"{int(clear.sum())} of {B} envs have every selection gap above {PROB_MARGIN}; on "
          f"them children, N, the plan and the counters are equal and W is within "
          f"{w_err:.3e} (atol {w_tol['atol']}); root_Qpi within "
          f"{(got.root_Qpi.cpu() - want.root_Qpi).abs().max().item():.3e}", flush=True)


def profile_planner(torch, dev, trace_dir) -> None:
    """Two planner iterations at the planner phase's env count, unfused and
    fused, from a search already ten iterations deep."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    agent, frames = planner_inputs(torch, dev, MCTS_ENVS)
    for tag, fused in (("unfused", False), ("fused", True)):
        # A threshold no env reaches: no iteration is masked out.
        p = mcts_lib.MCTSParams(repeats=MCTS_REPEATS, simulation_depth=3, threshold=1.1,
                                max_depth=MCTS_MAX_DEPTH, fused_eval=fused)
        with torch.inference_mode():
            carry = mcts_lib._init_search(agent, frames, p, (0,))
            mcts_lib._run_search(agent, carry, p, 10)

            def run():
                mcts_lib._run_search(agent, carry, p, carry.i + 2)

            profile_report(torch, f"planner, {tag}, {MCTS_ENVS} envs x 2 iterations "
                           f"(from iteration 12)", run,
                           trace_dir and Path(trace_dir) / f"planner_{tag}_trace.json")


# ------------------------------------------------------------ slice 4
@contextlib.contextmanager
def figure_recorders(torch, calls: dict):
    """The card's machine has no matplotlib, PIL or scikit-learn: while
    the block runs, the port's figure functions are
    recorders that check what each call gets (finite arrays of the right
    shapes, frames in [0, 1]) and count the calls in ``calls``."""
    import numpy as np

    from deep_active_inference_mc_torch.viz import generate_traversals as traversals_lib
    from deep_active_inference_mc_torch.viz import reconstructions_plot as recon_lib
    from deep_active_inference_mc_torch.viz import stats_plot as stats_plot_lib

    def frames_ok(tag, x, n=None):
        x = np.asarray(x)
        check(x.ndim == 4 and x.shape[1:3] == (64, 64) and (n is None or x.shape[0] == n),
              f"{tag}: frames of shape {x.shape}")
        check(bool(np.isfinite(x).all()) and x.min() >= 0.0 and x.max() <= 1.0,
              f"{tag}: frames outside [0, 1] or not finite")

    def traversals(decode_fn, s_dim, s_sample, S_real, filenames=(), **kw):
        s_sample, S_real = np.asarray(s_sample), np.asarray(S_real)
        check(s_sample.ndim == 2 and s_sample.shape[1] == s_dim
              and bool(np.isfinite(s_sample).all()), f"traversals: samples {s_sample.shape}")
        check(S_real.shape == (s_sample.shape[0], 6) and bool(np.isfinite(S_real).all()),
              f"traversals: factors {S_real.shape}")
        sweep = np.tile(s_sample.mean(0), (10, 1)).astype(np.float32)
        sweep[:, 0] = np.linspace(s_sample[:, 0].min(), s_sample[:, 0].max(), 10)
        frames_ok("traversals decode", decode_fn(sweep), 10)
        check(len(filenames) == 1, f"traversals: filenames {filenames}")
        calls["generate_traversals"] = calls.get("generate_traversals", 0) + 1

    def reconstructions(o0, o1, po1, filename, colour=False):
        for tag, x in (("o0", o0), ("o1", o1), ("po1", po1)):
            frames_ok(f"reconstructions {tag}", x, 7)
        calls["reconstructions_plot"] = calls.get("reconstructions_plot", 0) + 1

    def stats_series_ok(name):
        def plot(stats, filename):
            n = len(stats["F"])
            for k, v in stats.items():
                check(len(v) in (0, n), f"{name}: series {k} has {len(v)} of {n} epochs")
                check(all(bool(np.isfinite(np.asarray(x, dtype=np.float64)).all()) for x in v),
                      f"{name}: non-finite series {k}")
            calls[name] = calls.get(name, 0) + 1
        return plot

    with patched(traversals_lib, generate_traversals=traversals), \
            patched(recon_lib, reconstructions_plot=reconstructions), \
            patched(stats_plot_lib, stats_plot=stats_series_ok("stats_plot"),
                    behavior_plot=stats_series_ok("behavior_plot")):
        yield


def same_tree(a, b) -> bool:
    """Nested dicts, lists and tensors equal, tensors bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def top_adam_steps(opt) -> int:
    return int(next(iter(opt.state_dict()["state"].values()))["step"])


def phase_distill(torch, smi: str, checkpoint: Path, out_root: str, figures: dict) -> dict:
    """The distillation CLI on phase 4's checkpoint at the distill
    defaults (depth cut), then the trainer with its distill hook. Returns
    K1's launch counts and the distilled checkpoint."""
    from deep_active_inference_mc_torch.apps import distill as distill_app
    from deep_active_inference_mc_torch.apps import train as train_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.train import distill as distill_lib

    def replay_steps(cfg) -> int:
        n = cfg.distill_envs * cfg.distill_macro
        return cfg.distill_passes * (n // min(cfg.distill_batch, n))

    cfg = Config(distill_macro=DISTILL_MACRO)
    n_records = cfg.distill_envs * DISTILL_MACRO
    steps = replay_steps(cfg)
    print(f"[distill] depth cut: {DISTILL_ITERS} iterations (the CLI's default is 20), "
          f"{DISTILL_MACRO} decisions per collect (40), {DISTILL_SWEEP_STEPS}-step readouts "
          f"(100); {cfg.distill_envs} envs, {cfg.distill_repeats} repeats, expand_k "
          f"{cfg.distill_expand_k}, batch {cfg.distill_batch}, {cfg.distill_passes} passes and "
          f"{TRAIN_SWEEP_ENVS} readout envs are the defaults: {n_records} records, {steps} "
          f"replay steps per iteration; PyTorch's defaults", flush=True)
    timings = {"collect": [], "dstep": []}
    real_collect, real_dstep = distill_lib.Distiller.collect, distill_lib.Distiller.dstep

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timings[name].append(time.perf_counter() - t0)
            return out
        return run

    out_dir = Path(out_root) / "distilled"
    log = []
    before = torch.load(checkpoint / "state" / "state.pt", map_location="cpu", weights_only=True)
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    with recorded_plans(torch, log), patched(distill_lib.Distiller,
                                            collect=timed("collect", real_collect),
                                            dstep=timed("dstep", real_dstep)):
        t0 = time.perf_counter()
        res = distill_app.main(["-n", str(checkpoint), "-o", str(out_dir), "--iters",
                                str(DISTILL_ITERS), "--distill_macro", str(DISTILL_MACRO),
                                "--sweep_envs", str(TRAIN_SWEEP_ENVS), "--sweep_steps",
                                str(DISTILL_SWEEP_STEPS)])
        wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = res["cfg"]
    n_records, steps = cfg.distill_envs * cfg.distill_macro, replay_steps(cfg)
    check(len(log) == DISTILL_ITERS * DISTILL_MACRO,
          f"distill: {len(log)} plans, want {DISTILL_ITERS * DISTILL_MACRO}")
    check(all(B == cfg.distill_envs for B, _, _, _ in log), "distill: a plan of another width")
    for m in res["metrics"]:
        check(all(math.isfinite(v) for v in m.values()), f"distill: metrics {m}")
        check(m["distill_steps"] == steps, f"distill: {m['distill_steps']} steps, want {steps}")
    check(top_adam_steps(res["state"].opts["top"]) == steps * DISTILL_ITERS,
          f"distill: top Adam at step {top_adam_steps(res['state'].opts['top'])}, want "
          f"{steps * DISTILL_ITERS} (reset, then {steps} per iteration)")
    saved = torch.load(out_dir / "state" / "state.pt", map_location="cpu", weights_only=True)
    for k, v in before["agent"].items():
        if not k.startswith("top."):
            check(torch.equal(saved["agent"][k], v), f"distill: {k} changed")
    for k in ("mid", "down"):
        check(same_tree(saved["opt_states"][k], before["opt_states"][k]),
              f"distill: the {k} optimizer's state changed")
    readouts = DISTILL_ITERS + 1
    want = DISTILL_ITERS * (DISTILL_MACRO + steps) + readouts * DISTILL_SWEEP_STEPS
    check(launches.get("render", 0) == want,
          f"distill: {launches.get('render', 0)} K1 launches, want {want} ({DISTILL_MACRO} per "
          f"collect + {steps} per iteration's replay + {readouts} readouts x "
          f"{DISTILL_SWEEP_STEPS})")
    collect_s, dstep_s = timings["collect"], timings["dstep"]
    plan_s = sum(dt for _, dt, _, _ in log)
    iters = sum(min(int(r.repeats_done.max()) + cfg.distill_expand_k, cfg.distill_repeats)
                // cfg.distill_expand_k for _, _, r, _ in log)
    print(f"[distill] {DISTILL_ITERS} iterations in {wall:.2f}s: collect "
          f"{statistics.mean(collect_s) * 1e3:.1f} ms each ({[round(x, 3) for x in collect_s]} "
          f"s), plans/s of the collect {n_records / statistics.mean(collect_s):.1f}, "
          f"{plan_s / max(iters, 1) * 1e3:.2f} ms per planner iteration ({iters} iterations of "
          f"{cfg.distill_expand_k} x {cfg.distill_envs} leaves); replay "
          f"{statistics.median(dstep_s) * 1e3:.2f} ms per step (median of {len(dstep_s)}, "
          f"{min(cfg.distill_batch, n_records)} rows); readouts {res['readouts']}; peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches {launches} [{smi}]", flush=True)

    # The trainer's hook: one epoch with a distill phase before the save.
    hook_macro = 2
    argv = ["--batch", str(TRAIN_BATCH), *TRAIN_FLAGS, "--test_size", str(TRAIN_TEST_SIZE),
            "--sweep_envs", str(TRAIN_SWEEP_ENVS), "--rounds", str(TRAIN_ROUNDS),
            "--sweep_steps", str(TRAIN_SWEEP_STEPS), "--save_every", "1", "--epochs", "1",
            "--distill_every", "1", "--distill_macro", str(hook_macro),
            "--out_root", str(Path(out_root) / "hook")]
    drawn = dict(figures)
    LAUNCHES.clear()
    out = train_app.main(argv)
    hook = dict(LAUNCHES)
    hook_steps = replay_steps(out["cfg"])
    stats = out["stats"]
    check(all(stats[k][-1] != 0.0 for k in ("distill_kl_first", "distill_kl_last",
                                            "distill_target_entropy")),
          "trainer hook: the distill series were not filled")
    want = (2 * TRAIN_SWEEP_STEPS + 2 * TRAIN_ROUNDS + EVAL_RENDERS + 2 * TRAIN_SWEEP_STEPS
            + hook_macro + hook_steps)
    check(hook.get("render", 0) == want,
          f"trainer hook: {hook.get('render', 0)} K1 launches, want {want}")
    check(adam_steps(out["state"]) == {"top": TRAIN_ROUNDS + hook_steps, "mid": TRAIN_ROUNDS,
                                       "down": TRAIN_ROUNDS},
          f"trainer hook: Adam step counts {adam_steps(out['state'])}")
    saved = torch.load(out["folder"] / "checkpoints" / "state" / "state.pt", map_location="cpu",
                       weights_only=True)
    check(all(torch.equal(saved["agent"][f"top.{k}"], v.cpu())
              for k, v in out["state"].agent.top.state_dict().items()),
          "trainer hook: the checkpoint does not hold the distilled top")
    for name in ("generate_traversals", "stats_plot", "behavior_plot"):
        check(figures.get(name, 0) == drawn.get(name, 0) + 1, f"trainer hook: {name} calls")
    check(figures.get("reconstructions_plot", 0) == drawn.get("reconstructions_plot", 0) + 2,
          "trainer hook: reconstructions_plot calls")
    print(f"[distill] trainer hook: 1 epoch of {TRAIN_ROUNDS} rounds, then a phase of "
          f"{hook_macro} decisions and {hook_steps} replay steps before the save; launches "
          f"{hook} = the epoch's plus {hook_macro} + {hook_steps}; figures drawn by the "
          f"recorders {figures} [{smi}]", flush=True)
    return {"distill": launches, "train_distill_hook": hook}, out_dir


def phase_demo(torch, smi: str, checkpoint: Path) -> dict:
    """The demo's headless rounds on the distilled checkpoint. Returns
    K1's launch counts."""
    from deep_active_inference_mc_torch.apps import demo as demo_app
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    runs = {"habit": [], "ai": ["--steps", "7"], "mcts": ["--repeats", str(DEMO_REPEATS),
                                                          "--depth", "3"]}
    print(f"[demo] one round ({demo_app.DURATION_OF_ROUND} frames) per controller on the "
          f"distilled checkpoint; ai at 7 steps and 10 samples, mcts at {DEMO_REPEATS} "
          f"repeats and depth 3 (the demo's defaults)", flush=True)
    out_launches = {}
    for method, flags in runs.items():
        log = []
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        with recorded_plans(torch, log):
            out = demo_app.main(["-n", str(checkpoint), "--method", method, "--headless",
                                 str(demo_app.DURATION_OF_ROUND), *flags])
        launches = dict(LAUNCHES)
        trace = out["trace"]
        check(tuple(trace.shape) == (demo_app.DURATION_OF_ROUND,)
              and bool(torch.isfinite(trace).all()), f"demo {method}: score trace {trace}")
        check(out["plans"] >= 1 and launches.get("render", 0) == out["plans"],
              f"demo {method}: {launches.get('render', 0)} K1 launches, {out['plans']} plans")
        if method == "mcts":
            check(len(log) == out["plans"], f"demo mcts: {len(log)} planner calls, "
                  f"{out['plans']} plans")
        extra = ""
        if log:
            reps = torch.cat([r.repeats_done for _, _, r, _ in log]).double()
            extra = (f", {sum(dt for _, dt, _, _ in log) / len(log) * 1e3:.1f} ms per plan, "
                     f"repeats_done mean {reps.mean():.1f}")
        print(f"[demo] {method}: {demo_app.DURATION_OF_ROUND} frames in {out['wall']:.3f}s, "
              f"{out['fps']:.1f} frames/s, {out['plans']} plans per round, final score "
              f"{float(trace[-1]):+.4f}{extra}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, launches {launches} "
              f"[{smi}]", flush=True)
        out_launches[f"demo_{method}"] = launches
    return out_launches


def phase_causal(torch, smi: str, out_root: str, figures: dict) -> dict:
    """The causal trainer CLI: train, save, then resume. Returns K1's
    launch counts."""
    from deep_active_inference_mc_torch.apps import train_causal as causal_app
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    argv = ["--batch", str(TRAIN_BATCH), "--test_size", str(TRAIN_TEST_SIZE), "--rounds",
            str(TRAIN_ROUNDS), "--save_every", "1", "--out_root", str(Path(out_root) / "causal")]
    print(f"[causal] depth cut: {TRAIN_ROUNDS} rounds per epoch (1000), {TRAIN_EPOCHS}+1 "
          f"epochs; batch {TRAIN_BATCH}, test_size {TRAIN_TEST_SIZE} and the model's widths "
          f"are the defaults; l_rate 1e-4", flush=True)
    drawn = dict(figures)
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    first = causal_app.main(argv + ["--epochs", str(TRAIN_EPOCHS)])
    launches = dict(LAUNCHES)
    LAUNCHES.clear()
    resumed = causal_app.main(argv + ["--resume", "--epochs", str(TRAIN_EPOCHS + 1)])
    launches_resumed = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(resumed["start_epoch"] == TRAIN_EPOCHS + 1,
          f"causal resume: started at epoch {resumed['start_epoch']}")
    stats = resumed["stats"]
    for k in ("F", "mse_o", "kl_div_s", "omega"):
        check(len(stats[k]) == TRAIN_EPOCHS + 1 and all(math.isfinite(v) for v in stats[k]),
              f"causal: series {k} {stats[k]}")
    check(stats["F"][-1] < stats["F"][0], f"causal: F did not fall {stats['F']}")
    for tag, got, epochs in (("causal", launches, TRAIN_EPOCHS),
                             ("causal resume", launches_resumed, 1)):
        want = epochs * (2 * TRAIN_ROUNDS + 2)  # 2 per round, 2 per eval
        check(got.get("render", 0) == want,
              f"{tag}: {got.get('render', 0)} K1 launches, want {want} (2 per round)")
    epochs = TRAIN_EPOCHS + 1
    for name, per_epoch in (("generate_traversals", 1), ("reconstructions_plot", 1)):
        check(figures.get(name, 0) == drawn.get(name, 0) + per_epoch * epochs,
              f"causal: {name} drawn {figures.get(name, 0) - drawn.get(name, 0)} times")
    secs = first["epoch_seconds"] + resumed["epoch_seconds"]
    print(f"[causal] F by epoch {[round(v, 5) for v in stats['F']]}, cf figures every epoch; "
          f"{[round(s / TRAIN_ROUNDS * 1e3, 3) for s in secs]} ms per round by epoch (the "
          f"first pays cuDNN's algorithm search); peak memory {peak / 2 ** 20:.1f} MiB; "
          f"launches {launches} then {launches_resumed} [{smi}]", flush=True)
    return {"causal": launches, "causal_resume": launches_resumed}


# ------------------------------------------------------------ slice 5
def tf32_off(torch):
    """Context: TF32 off for matmuls and convolutions (restored after)."""
    @contextlib.contextmanager
    def ctx():
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return ctx()


def rel_rms(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).square().mean().sqrt() / want.square().mean().sqrt())


def train_argv(out_root, epochs: int, rounds: int = 0, sweep_steps: int = 0) -> list:
    """The training phase's trainer flags, figures off (a mesh's ranks are
    processes of their own, without this script's figure recorders)."""
    rounds, sweep_steps = rounds or TRAIN_ROUNDS, sweep_steps or TRAIN_SWEEP_STEPS
    return ["--batch", str(TRAIN_BATCH), *TRAIN_FLAGS, "--test_size", str(TRAIN_TEST_SIZE),
            "--sweep_envs", str(TRAIN_SWEEP_ENVS), "--rounds", str(rounds), "--sweep_steps",
            str(sweep_steps), "--epochs", str(epochs), "--save_every", "1", "--viz_every",
            "1000", "--out_root", str(out_root)]


def check_stats(torch, tag: str, stats: dict) -> None:
    for k, series in stats.items():
        check(all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in series),
              f"{tag}: non-finite stats series {k}")


def phase_bf16(torch, dev, smi: str, f32_ms_macro: float, f32_ms_round: list,
               checkpoint: Path, out_root: str) -> dict:
    """bf16 forwards through the sweep, trainer, planner and distillation
    CLIs at full width, the planner's float32 G and the card's bf16 shift
    from its float32 (TF32 off). Returns K1's launch counts."""
    import copy

    from deep_active_inference_mc_torch.apps import distill as distill_app
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.apps import train as train_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer import efe
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib
    from deep_active_inference_mc_torch.train import loop as train_loop

    runs = {}
    peak = lambda: f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB"
    # (a) the ai sweep.
    base = ["--envs", str(SWEEP_ENVS), "--jumps", str(JUMPS), "--steps", "1", "--samples", "1",
            "--seed", "0", "--method", "ai", "--bf16"]
    sweep_app.main(base + ["--macro", "2"])  # warm-up: cuDNN picks its bf16 algorithms
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    out = sweep_app.main(base + ["--macro", str(SWEEP_MACRO)])
    runs["sweep_ai_bf16"] = dict(LAUNCHES)
    check(bool(torch.isfinite(out["scores"]).all()), "bf16 ai sweep: non-finite scores")
    check(runs["sweep_ai_bf16"].get("render", 0) == SWEEP_MACRO, "bf16 ai sweep: K1 launches")
    ms = out["wall"] / SWEEP_MACRO * 1e3
    print(f"[bf16] ai sweep: {SWEEP_ENVS} envs x {SWEEP_MACRO} macro, {ms:.3f} ms/macro "
          f"(float32, phase 3: {f32_ms_macro:.3f}), env-steps/s "
          f"{SWEEP_ENVS * SWEEP_MACRO * JUMPS / out['wall']:.4e}, peak {peak()} [{smi}]",
          flush=True)

    # (b) the trainer: one epoch at the training phase's batch and flags.
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    out = train_app.main(train_argv(Path(out_root) / "bf16", 2) + ["--bf16"])
    runs["train_bf16"] = dict(LAUNCHES)
    check_stats(torch, "bf16 train", out["stats"])
    check(out["round_launches"] == [2 * TRAIN_ROUNDS] * 2,
          f"bf16 train: K1 launches in the rounds {out['round_launches']}")
    repeats = train_config().repeats
    ms = [round(TRAIN_BATCH * repeats / sps * 1e3, 3) for sps in out["env_steps_per_s"]]
    print(f"[bf16] train: 2 epochs of {TRAIN_ROUNDS} rounds at batch {TRAIN_BATCH}, {ms} "
          f"ms/round by epoch (float32, phase 4's first run: {f32_ms_round}), F_down "
          f"{out['stats']['F_down'][-1]:.2f}, peak {peak()} [{smi}]", flush=True)

    # (c) the fused planner.
    mcts = ["--method", "mcts", "--jumps", str(JUMPS), "--seed", "0", "--envs", str(MCTS_ENVS),
            "--mcts_fused", "--bf16"]
    sweep_app.main(mcts + ["--macro", "1", "--mcts_repeats", "2"])  # warm-up
    log = []
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    with recorded_plans(torch, log):
        out = sweep_app.main(mcts + ["--macro", str(MCTS_MACRO)])
    runs["sweep_mcts_fused_bf16"] = dict(LAUNCHES)
    check(bool(torch.isfinite(out["scores"]).all()), "bf16 mcts: non-finite scores")
    check(len(log) == MCTS_MACRO and runs["sweep_mcts_fused_bf16"].get("render", 0) == MCTS_MACRO,
          "bf16 mcts: plans or K1 launches")
    report_plans(torch, "mcts_fused_bf16", log, MCTS_ENVS, MCTS_MACRO, out["wall"],
                 runs["sweep_mcts_fused_bf16"], smi)

    # (d) one short distillation run on phase 4's checkpoint.
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    res = distill_app.main(["-n", str(checkpoint), "-o", str(Path(out_root) / "distilled_bf16"),
                            "--iters", "1", "--distill_macro", "2", "--sweep_envs",
                            str(TRAIN_SWEEP_ENVS), "--sweep_steps", "2", "--bf16"])
    runs["distill_bf16"] = dict(LAUNCHES)
    check(all(math.isfinite(v) for m in res["metrics"] for v in m.values()),
          f"bf16 distill: metrics {res['metrics']}")
    print(f"[bf16] distill: 1 iteration of 2 decisions at {res['cfg'].distill_envs} envs, "
          f"metrics {res['metrics'][0]}, readouts {res['readouts']}, peak {peak()} [{smi}]",
          flush=True)

    # (e) float32 G in the planner; the bf16 shift in G and in one round.
    cfg = train_config()
    agent = sweep_app.build_agent(Config(), "", dev)
    agent_bf16 = sweep_app.build_agent(Config(), "", dev, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(3)
    p = mcts_lib.MCTSParams(repeats=MCTS_REPEATS, fused_eval=True, max_depth=MCTS_MAX_DEPTH)
    with torch.inference_mode():
        s = torch.randn((MCTS_ENVS, 10), generator=g, device=dev)
        terms = mcts_lib._fused_expand_sim(agent_bf16, s, p, generator=g)
    check(all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in terms),
          f"bf16 planner: G terms {[t.dtype for t in terms]}")
    lut = raster.build_sprite_lut(dev)
    env = env_lib.randomize(env_lib.reset(g, SWEEP_ENVS, dev), g)
    rollout = efe.draw_rollout(agent, SWEEP_ENVS, SWEEP_ENVS * 4, g, dev, steps=1,
                               calc_mean=True, samples=1, mean_estimator=True)
    draws = train_loop.draw_round(agent, cfg, TRAIN_BATCH, g, dev)
    with tf32_off(torch):
        with torch.inference_mode():
            o = env_lib.render(lut, env)
            G = [efe.calculate_G_4_repeated(a, o, steps=1, calc_mean=True, samples=1,
                                            draws=rollout)[0] for a in (agent, agent_bf16)]
        losses = []
        for a in (agent, agent_bf16):
            state = train_loop.TrainState(
                a, train_loop.make_optimizers(cfg, a),
                train_loop.PrecisionState.create(cfg.gamma, cfg.beta_s, cfg.beta_o, dev),
                env_lib.reset(g, TRAIN_BATCH, dev))
            _, m = train_loop.make_round_fn(cfg, lut)(state, draws=copy.deepcopy(draws))
            losses.append({k: float(m[k]) for k in ("F_top", "F_mid", "F_down")})
    check(bool(torch.isfinite(G[1]).all()) and G[1].dtype == torch.float32, "bf16 G")
    check(all(math.isfinite(v) for v in losses[1].values()), f"bf16 round: {losses[1]}")
    shift = {k: abs(losses[1][k] - losses[0][k]) / abs(losses[0][k]) for k in losses[0]}
    print(f"[bf16] the card's bf16 shift from its float32, TF32 off: G of {SWEEP_ENVS} x 4 rows "
          f"rel RMS {rel_rms(torch, G[1], G[0]):.3e}, max |diff| "
          f"{(G[1] - G[0]).abs().max().item():.3e} (G rms "
          f"{G[0].double().square().mean().sqrt().item():.1f}); one round at batch "
          f"{TRAIN_BATCH}, relative: " + ", ".join(f"{k} {v:.3e}" for k, v in shift.items()),
          flush=True)
    return runs


def mesh_round(mesh, cases, tf32: bool):
    """Rank body of phase 12's injected-noise rounds: for each (cfg, full
    weights, global draws) of ``cases``, one round on this rank's shard, on
    its card. Returns the metrics and the full weights after each."""
    import torch

    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
    from deep_active_inference_mc_torch.train import loop as train_loop

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    dev = mesh.device
    lut = raster.build_sprite_lut(dev)
    out = []
    for cfg, sd, draws in cases:
        agent = sweep_app.build_agent(Config(), "", dev)
        agent.load_state_dict(sd)
        state = train_loop.TrainState(
            agent, train_loop.make_optimizers(cfg, agent),
            train_loop.PrecisionState.create(cfg.gamma, cfg.beta_s, cfg.beta_o, dev),
            env_lib.reset(torch.Generator(device=dev).manual_seed(0), cfg.batch, dev))
        state = mesh_lib.shard_train_state(state, mesh, cfg)
        _, m = train_loop.make_round_fn(cfg, lut, mesh)(state, draws=to_device(draws, dev))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": mesh_lib.full_state_dict(state.agent, mesh)})
    return out


def phase_mesh(torch, dev, smi: str, f32_ai: dict, out_root: str) -> dict:
    """Multi-device training and sweeps: the trainer CLI on R ranks, a
    single-rank resume of its checkpoint, tensor parallelism, one sharded
    round against one rank on injected noise, the sharded sweep against
    phase 3's, and two coordinated host processes. Returns K1's launch
    counts per rank."""
    import copy
    import socket

    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.apps import train as train_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
    from deep_active_inference_mc_torch.train import loop as train_loop

    n_cards = torch.cuda.device_count()
    R = min(n_cards, 4) if n_cards >= 2 else 2
    backend = "nccl" if n_cards >= R else "gloo"
    print(f"[mesh] {R} ranks on {n_cards} card(s), backend {backend}"
          f"{' (the ranks share one card: not scaling)' if n_cards < R else ''}", flush=True)
    repeats = train_config().repeats
    runs = {}
    root = Path(out_root) / "mesh"

    def check_mesh_run(tag, out, ranks, epochs, rounds=TRAIN_ROUNDS):
        check(len(out["ranks"]) == ranks, f"{tag}: {len(out['ranks'])} ranks")
        check_stats(torch, tag, out["stats"])
        for r in out["ranks"]:
            check(r["backend"] == backend, f"{tag}: rank {r['rank']} on {r['backend']}")
            check(r["round_launches"] == [2 * rounds] * epochs,
                  f"{tag}: rank {r['rank']} K1 launches in the rounds {r['round_launches']}, "
                  f"want {2 * rounds} per epoch (2 per round)")
            check(set(r["adam_steps"].values()) == {epochs * rounds},
                  f"{tag}: rank {r['rank']} Adam steps {r['adam_steps']}")
            runs[f"{tag}_rank{r['rank']}"] = {"render": sum(r["round_launches"])}
        ms = [TRAIN_BATCH * repeats / r["env_steps_per_s"][-1] * 1e3 for r in out["ranks"]]
        print(f"[mesh] {tag}: {out['ranks'][0]['mesh']}; {epochs} epoch(s) of {rounds} "
              f"rounds at global batch {TRAIN_BATCH}, ms/round by rank "
              f"{[round(x, 3) for x in ms]}, K1 launches per rank in the rounds "
              f"{[sum(r['round_launches']) for r in out['ranks']]} (2 per round, at "
              f"{TRAIN_BATCH // (ranks // out['cfg'].tp)} envs per rank), devices "
              f"{sorted({r['device'] for r in out['ranks']})} [{smi}]", flush=True)

    # (a) data parallel, one epoch, saved.
    out = train_app.main(train_argv(root / "dp", 1) + ["--mesh_shape", str(R)])
    check_mesh_run("train_mesh", out, R, 1)
    # (b) the mesh's checkpoint resumed on one rank.
    res = train_app.main(train_argv(root / "dp", 2) + ["--resume"])
    check(res["start_epoch"] == 2 and set(adam_steps(res["state"]).values()) == {
        2 * TRAIN_ROUNDS}, f"single-rank resume of the mesh checkpoint: epoch "
        f"{res['start_epoch']}, Adam {adam_steps(res['state'])}")
    check(res["stats"]["F"][:1] == out["stats"]["F"], "resume: the mesh's stats were not kept")
    print(f"[mesh] the {R}-rank checkpoint resumed on one rank at epoch 2, Adam steps "
          f"{adam_steps(res['state'])}, "
          f"{TRAIN_BATCH * repeats / res['env_steps_per_s'][-1] * 1e3:.3f} ms/round", flush=True)
    # (c) tensor parallel; depth cut to half an epoch, since ranks sharing
    # one card stage each of its ~100 collectives per round through the host.
    tp_rounds = TRAIN_ROUNDS // 2
    out = train_app.main(train_argv(root / "tp", 1, rounds=tp_rounds)
                         + ["--mesh_shape", str(R), "--tp", "2"])
    check_mesh_run("train_mesh_tp2", out, R, 1, tp_rounds)

    # (d) one injected-noise round, sharded against one rank, TF32 off, at
    # tests/test_parallel.py's batch of 8 and at the training phase's 512,
    # to that test's tolerances. As its docstring says of the JAX mesh, the
    # weights agree "up to Adam's step-1 sign-noise on near-zero-gradient
    # elements": where a gradient entry cancels to rounding noise, the
    # reduction order picks its sign, and Adam's first step (lr * g/|g|)
    # follows it. An entry beyond the tolerance is accepted only as such a
    # step (off by at most 2 lr of its layer), and only in 1 of 10^4.
    cases = []
    for batch, seed in ((8, 7), (TRAIN_BATCH, 8)):
        cfg = Config.from_args(TRAIN_FLAGS, batch=batch)
        agent = sweep_app.build_agent(Config(), "", torch.device("cpu"))
        draws = train_loop.draw_round(agent, cfg, batch, torch.Generator().manual_seed(seed),
                                      torch.device("cpu"))
        cases.append((cfg, copy.deepcopy(agent.state_dict()), draws))
    with tf32_off(torch):
        refs = mesh_round(mesh_lib.Mesh(0, 1, 1, dev, "none"), cases, False)
    keys = ("F_down", "omega", "gnorm_top", "gnorm_mid", "gnorm_down")
    for tp, atol in ((1, 5e-5), (2, 3e-4)):
        got = mesh_lib.launch(mesh_round, (cases, False), world=R, n_model=tp)
        for (cfg, _, _), ref, *by_rank in zip(cases, refs, *got):
            lr = {"top": cfg.l_rate_top, "mid": cfg.l_rate_mid, "down": cfg.l_rate_down}
            rel = {k: max(abs(g["metrics"][k] - ref["metrics"][k]) / abs(ref["metrics"][k])
                          for g in by_rank) for k in keys}
            worst, steps, bad = 0.0, 0, 0
            for g in by_rank:
                for k, v in ref["params"].items():
                    d = (g["params"][k] - v.cpu()).abs()
                    worst = max(worst, float(d.max()))
                    beyond = d > atol
                    steps += int(beyond.sum())
                    bad += int((d[beyond] > 2.002 * lr[k.split(".")[0]]).sum())
            n = sum(v.numel() for v in ref["params"].values()) * len(by_rank)
            for k, v in rel.items():
                check(v <= 2e-3, f"sharded round B={cfg.batch} tp={tp}: {k} rel diff {v:.3e}")
            check(bad == 0 and steps <= n * 1e-4,
                  f"sharded round B={cfg.batch} tp={tp}: {steps} weights beyond atol {atol}, "
                  f"{bad} of them more than an Adam step off")
            print(f"[mesh] one round, batch {cfg.batch}, {R} ranks, tp {tp}, injected noise, "
                  f"TF32 off, against one rank (worst rank): rel diff " + ", ".join(
                      f"{k} {v:.3e}" for k, v in rel.items()) + f" (rtol 2e-3); weights max "
                  f"|diff| {worst:.3e}, within atol {atol} but {steps} of {n} (over the ranks), "
                  f"each an Adam sign step", flush=True)

    # (e) the sharded ai sweep against phase 3's single-rank sweep.
    base = ["--envs", str(SWEEP_ENVS), "--jumps", str(JUMPS), "--steps", "1", "--samples", "1",
            "--seed", "0", "--method", "ai", "--macro", str(SWEEP_MACRO), "--mesh", str(R)]
    out = sweep_app.main(base)
    same = int((out["scores"] == f32_ai["scores"]).sum())
    print(f"[mesh] ai sweep, {SWEEP_ENVS} envs x {SWEEP_MACRO} macro over {R} ranks: "
          f"{same} of {SWEEP_ENVS} scores equal phase 3's single-rank sweep; mean "
          f"{float(out['scores'].mean()):.4f} against {float(f32_ai['scores'].mean()):.4f}; "
          f"{out['wall'] / SWEEP_MACRO * 1e3:.3f} ms/macro (one rank: "
          f"{f32_ai['ms_macro']:.3f}) [{smi}]", flush=True)
    check(same == SWEEP_ENVS, f"mesh ai sweep: {SWEEP_ENVS - same} scores differ from one rank's")

    # (f) two host processes meeting at a coordinator on this machine.
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    argv = train_argv(root / "hosts", 1, rounds=4, sweep_steps=2)
    procs = []
    for h in (0, 1):
        env = dict(os.environ)
        if n_cards >= 2:
            env["CUDA_VISIBLE_DEVICES"] = str(h)
        else:
            env["DAIF_DIST_BACKEND"] = "gloo"  # the two hosts share the one card
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{PACKAGE}.apps.train", *argv, "--coordinator",
             f"127.0.0.1:{port}", "--num_hosts", "2", "--host_id", str(h)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for h, (pr, text) in enumerate(zip(procs, outs)):
        check(pr.returncode == 0, f"host {h} exited {pr.returncode}:\n{text[-3000:]}")
    lines = [[ln for ln in text.splitlines() if ", F: " in ln] for text in outs]
    check(len(lines[0]) == 1 and not lines[1], f"coordinated hosts: epoch lines {lines}")
    print(f"[mesh] two host processes at 127.0.0.1:{port}: "
          f"{[ln for ln in outs[0].splitlines() if ln.startswith('mesh:')]}; host 0: "
          f"{lines[0][0][:60]}...; host 1 printed and wrote nothing", flush=True)
    return runs


# ------------------------------------------------------------ slice 6
FLAGSHIP = Path("artifacts") / "run512" / "checkpoints"  # the JAX CLIs' -n, repo-relative
EXPORT = "torch_export.npz"
LADDER_LOG = Path("artifacts") / "run512" / "eval_log_round5.txt"
LADDER_SIGMA = 4.0  # gate: |port - committed| <= 4 sqrt(se_port^2 + se_committed^2)
LADDER_ENVS_FULL, LADDER_AI_ENVS, LADDER_MACRO_FULL = 4096, 1024, 200  # eval_log_round5.txt
JAX_TRAINED_EXPANSIONS = 107.29  # BENCH_r05.json mcts_trained_avg_expansions (JAX, TPU v5e)
FLAGSHIP_PLAN_ENVS = 256
FLAGSHIP_QUEUE_ENVS, FLAGSHIP_QUEUE_MACRO = 512, 6  # the ladder's best row, depth cut from 200
EDGE_MAX_WRONG = 0.08  # tests/test_trained_artifact.py's flagship contract
MSE_BAND = (0.85, 1.25)  # the resumed epoch's MSEo over the run's last 10 epochs' median
AI_FLAGS = ["--method", "ai", "--steps", "2", "--env_chunk", "1024"]  # scripts/final_eval.sh
MCTS_LADDER_FLAGS = ["--method", "mcts", "--mcts_repeats", str(REF_BUDGET), "--mcts_fused",
                     "--bf16", "--plan_queue", "--mcts_c", "2"]
# Ladder rows, tag: (label in the committed log, envs, the sweep CLI's flags,
# TF32 off). The default run takes LADDER_ROWS; --ladder adds FULL_LADDER's.
LADDER_ROWS = {
    "random": ("random", LADDER_ENVS_FULL, ["--method", "random"], False),
    "expert": ("expert", LADDER_ENVS_FULL, ["--method", "expert"], False),
    "habit": ("habit", LADDER_ENVS_FULL, ["--method", "habit"], False),
    "ai_tf32_off": ("ai", LADDER_AI_ENVS, AI_FLAGS, True),
    "ai_tf32_defaults": ("ai", LADDER_AI_ENVS, AI_FLAGS, False),
}
FULL_LADDER = {
    "ai_4096_tf32_off": ("ai", LADDER_ENVS_FULL, AI_FLAGS, True),
    "ai_4096_tf32_defaults": ("ai", LADDER_ENVS_FULL, AI_FLAGS, False),
    "mcts_c2+queue": ("mcts_c2+queue", MCTS_ENVS, MCTS_LADDER_FLAGS + ["--chunk", "8"], False),
    "mcts_c2_bucketed+queue": ("mcts_c2_bucketed+queue", LADDER_ENVS,
                               MCTS_LADDER_FLAGS + ["--mcts_bucketed"], False),
}


def committed_ladder() -> dict:
    """label -> (mean, sem, envs) of every row of the committed ladder."""
    rows = {}
    for line in (ROOT / LADDER_LOG).read_text().splitlines():
        if line.startswith("method="):
            f = line.split()
            score = line.split("score: ")[1].split()
            rows[f[0][len("method="):]] = (float(score[0]), float(score[2]),
                                           int(next(x for x in f if x.startswith("envs="))[5:]))
    return rows


def flagship_ladder_rows(torch, smi: str, extra: list) -> dict:
    """Ladder rows through the sweep CLI on the flagship at the committed
    protocol (LADDER_ROWS, then the FULL_LADDER rows named in ``extra``),
    each gated against its committed row. Returns K1's launch counts by
    row."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    committed = committed_ladder()
    base = ["-n", str(ROOT / FLAGSHIP), "--seed", "0", "--jumps", str(JUMPS),
            "--macro", str(LADDER_MACRO_FULL)]
    rows = dict(LADDER_ROWS, **{tag: FULL_LADDER[tag] for tag in extra})
    runs, misses = {}, []
    for tag, (label, envs, flags, off) in rows.items():
        mean_c, sem_c, envs_c = committed[label]
        log = []
        LAUNCHES.clear()
        with (tf32_off(torch) if off else contextlib.nullcontext()), recorded_plans(torch, log):
            tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            out = sweep_app.main(base + ["--envs", str(envs)] + flags)
        launches = dict(LAUNCHES)
        scores = out["scores"]
        check(bool(torch.isfinite(scores).all()) and tuple(scores.shape) == (envs,),
              f"ladder {tag}: scores {tuple(scores.shape)} not all finite")
        # K1 renders once per macro step that planned (mcts), else once per
        # macro step and env group.
        groups = -(-envs // int(flags[flags.index("--env_chunk") + 1])) \
            if "--env_chunk" in flags else 1
        want = len(log) if flags[1] == "mcts" else LADDER_MACRO_FULL * groups
        check(launches.get("render", 0) == want,
              f"ladder {tag}: {launches.get('render', 0)} K1 launches, want {want}")
        mean, sem = out["score_mean"], out["score_sem"]
        sigma = abs(mean - mean_c) / math.sqrt(sem ** 2 + sem_c ** 2)
        if sigma > LADDER_SIGMA:
            misses.append(tag)
        plans = ""
        if log:
            reps = torch.cat([r.repeats_done for _, _, r, _ in log]).double()
            iters = sum(min(int(r.repeats_done.max()) + 1, REF_BUDGET) for _, _, r, _ in log)
            plans = (f", {len(log)} planner calls over {sum(B for B, _, _, _ in log)} rows, "
                     f"{sum(dt for _, dt, _, _ in log) / iters * 1e3:.2f} ms per planner "
                     f"iteration, repeats_done mean {reps.mean():.2f}")
        print(f"[flagship] ladder {tag}: {envs} envs x {LADDER_MACRO_FULL} macro x {JUMPS} jumps "
              f"(cuBLAS TF32 {tf32[0]}, cuDNN TF32 {tf32[1]}): {mean:+.4f} +- {sem:.4f}, "
              f"committed {mean_c:+.3f} +- {sem_c:.3f} at {envs_c} envs: {sigma:.2f} sigma "
              f"(gate {LADDER_SIGMA}); wall {out['wall']:.2f}s, "
              f"{out['wall'] / LADDER_MACRO_FULL * 1e3:.2f} ms/macro{plans}, launches {launches} "
              f"[{smi}]", flush=True)
        runs[f"flagship_ladder_{tag}"] = launches
    check(not misses, f"ladder rows beyond {LADDER_SIGMA} sigma of the committed ladder: {misses}")
    return runs


def phase_flagship(torch, dev, smi: str, out_root: str, figures: dict, ladder: str) -> dict:
    """The committed flagship agent through the port's CLIs, with the
    FULL_LADDER rows named in ``ladder`` (comma-separated). Returns K1's
    launch counts by path."""
    import numpy as np

    from deep_active_inference_mc_torch.apps import demo as demo_app
    from deep_active_inference_mc_torch.apps import distill as distill_app
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.apps import train as train_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib
    from deep_active_inference_mc_torch.train import evaluate
    from deep_active_inference_mc_torch.utils import convert

    t_phase = time.perf_counter()
    extra = [tag for tag in ladder.split(",") if tag]
    unknown = sorted(set(extra) - set(FULL_LADDER))
    check(not unknown, f"--ladder: no such rows {unknown} (rows: {sorted(FULL_LADDER)})")
    export = convert.load_export(ROOT / FLAGSHIP / EXPORT)
    lut = raster.build_sprite_lut(dev)
    runs = {}

    # (a) the weights on the card are the export's, bit for bit.
    agent = sweep_app.build_agent(Config(), str(ROOT / FLAGSHIP), dev)
    sd = agent.state_dict()
    check(sd.keys() == export["agent"].keys(), "flagship: the agent's keys are not the export's")
    differ = [k for k, v in export["agent"].items() if not torch.equal(sd[k].cpu(), v)]
    check(not differ, f"flagship: weights differ from the export: {differ[:5]}")
    n_params = sum(v.numel() for v in sd.values())
    print(f"[flagship] {FLAGSHIP}: {n_params} parameters on the card equal {EXPORT}, bit for "
          f"bit; precision {({k: float(v) for k, v in export['precision'].items()})}", flush=True)

    # (b) the habit net's edge-policy contrast.
    left, right = evaluate.habit_edge_policy(agent, lut)
    check(bool(left[0] > 2 * right[0] + 1e-3) and bool(right[0] < EDGE_MAX_WRONG),
          f"flagship edge policy: squares left {float(left[0]):.4f}, right {float(right[0]):.4f}")
    for c in (1, 2):
        check(bool(right[c] > 2 * left[c] + 1e-3) and bool(left[c] < EDGE_MAX_WRONG),
              f"flagship edge policy: class {c} left {float(left[c]):.4f}, right "
              f"{float(right[c]):.4f}")
    print(f"[flagship] habit P(up) at the scoring edge, left / right by class (square, "
          f"ellipse, heart): {np.round(left.numpy(), 5).tolist()} / "
          f"{np.round(right.numpy(), 5).tolist()}: the sorting contrast holds (wrong side < "
          f"{EDGE_MAX_WRONG})", flush=True)

    # (c) ladder rows at the committed protocol.
    runs.update(flagship_ladder_rows(torch, smi, extra))

    # (d) the trained-prior planner: one plan at the reference budget.
    g = torch.Generator(device=dev).manual_seed(0)
    LAUNCHES.clear()
    with torch.inference_mode():
        frames = env_lib.render(lut, env_lib.reset(g, FLAGSHIP_PLAN_ENVS, dev))
    runs["flagship_plan_frames"] = dict(LAUNCHES)
    p = mcts_lib.MCTSParams(repeats=REF_BUDGET, simulation_depth=3, max_depth=MCTS_MAX_DEPTH,
                            fused_eval=True)
    bucketed = mcts_lib.make_bucketed_planner(agent, p)
    for tag, plan in (("plain", lambda: mcts_lib.active_inference_mcts(agent, frames, p, (0,))),
                      ("bucketed", lambda: bucketed(frames, (0,)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_plan(torch, f"flagship plan, {tag}", res, p)
        reps = res.repeats_done.double()
        trace = ""
        if tag == "bucketed":
            check(len(bucketed.bucket_trace) > 1, f"flagship plan: no compaction under the "
                  f"trained prior (buckets {bucketed.bucket_trace})")
            trace = f", buckets {bucketed.bucket_trace} at iterations {bucketed.schedule}"
        print(f"[flagship] plan at the reference budget ({REF_BUDGET} repeats, fused, float32), "
              f"{tag}: {FLAGSHIP_PLAN_ENVS} envs in {dt:.4f}s, plans/s "
              f"{FLAGSHIP_PLAN_ENVS / dt:.2f}; repeats_done mean {reps.mean():.2f} (JAX package "
              f"{JAX_TRAINED_EXPANSIONS}/{REF_BUDGET}, BENCH_r05.json) max {int(reps.max())}, "
              f"depth_capped {int(res.depth_capped.sum())}{trace} [{smi}]", flush=True)

    # (d) the ladder's best configuration on the trained prior, depth cut.
    log = []
    LAUNCHES.clear()
    with recorded_plans(torch, log):
        out = sweep_app.main(["-n", str(ROOT / FLAGSHIP), "--seed", "0", "--jumps", str(JUMPS),
                              "--envs", str(FLAGSHIP_QUEUE_ENVS), "--macro",
                              str(FLAGSHIP_QUEUE_MACRO), *MCTS_LADDER_FLAGS, "--mcts_bucketed"])
    launches = dict(LAUNCHES)
    check(bool(torch.isfinite(out["scores"]).all()), "flagship bucketed queue: scores")
    check(1 <= len(log) <= FLAGSHIP_QUEUE_MACRO and launches.get("render", 0) == len(log),
          f"flagship bucketed queue: {launches.get('render', 0)} K1 launches, {len(log)} plans")
    compactions = sum(len(tr) - 1 for _, _, _, tr in log)
    check(compactions >= 1, "flagship bucketed queue: no compaction under the trained prior")
    report_plans(torch, f"flagship bucketed queue C=2 ({REF_BUDGET} repeats, fused, bf16)", log,
                 FLAGSHIP_QUEUE_ENVS, FLAGSHIP_QUEUE_MACRO, out["wall"], launches, smi, REF_BUDGET)
    print(f"[flagship] bucketed queue: {compactions} compactions over {len(log)} plans; score "
          f"{out['score_mean']:+.4f} +- {out['score_sem']:.4f} after {FLAGSHIP_QUEUE_MACRO} "
          f"macro steps", flush=True)
    runs["flagship_mcts_bucketed_queue"] = launches

    # (e) the trainer resumes the flagship run with its config.json flags.
    cfg_run = json.loads((ROOT / FLAGSHIP.parent / "config.json").read_text())
    default = dataclasses.asdict(Config())
    # A run folder of its own: phase 4's run has the same signature.
    cut = {"rounds": TRAIN_ROUNDS, "sweep_steps": TRAIN_SWEEP_STEPS,
           "out_root": str(Path(out_root) / "flagship")}
    argv = []
    for k, v in cfg_run.items():
        v = cut.get(k, v)
        if v == default[k] or v is None or k == "epochs":
            continue
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    cfg = Config.from_args(argv)
    with open(ROOT / FLAGSHIP / "stats.pkl", "rb") as f:
        history = pickle.load(f)
    n_done = len(history["F"])
    shutil.copytree(ROOT / FLAGSHIP, cfg.folder_chp)
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    out = train_app.main(argv + ["--resume", "--epochs", str(n_done + 1)])
    launches = dict(LAUNCHES)
    check(out["start_epoch"] == n_done + 1, f"flagship resume: started at epoch "
          f"{out['start_epoch']}, want {n_done + 1}")
    check_stats(torch, "flagship resume", out["stats"])
    top = out["state"].agent.top.state_dict()
    check(all(torch.equal(v.cpu(), export["agent"][f"top.{k}"]) for k, v in top.items()),
          "flagship resume: top changed under freeze_top")
    steps = {k: [int(s["step"]) for s in o.state_dict()["state"].values()]
             for k, o in out["state"].opts.items()}
    check(steps["top"] == [] and all(set(steps[k]) == {TRAIN_ROUNDS} for k in ("mid", "down")),
          f"flagship resume: Adam steps {steps}, want fresh Adams at {TRAIN_ROUNDS} (top none)")
    ref = statistics.median(history["mse_o"][-10:])
    mse = out["stats"]["mse_o"][-1]
    check(MSE_BAND[0] * ref <= mse <= MSE_BAND[1] * ref,
          f"flagship resume: MSEo {mse:.2f} outside {MSE_BAND} x {ref:.2f}")
    want = 4 * TRAIN_SWEEP_STEPS + 2 * TRAIN_ROUNDS + EVAL_RENDERS
    check(launches.get("render", 0) == want and out["round_launches"] == [2 * TRAIN_ROUNDS],
          f"flagship resume: {launches.get('render', 0)} K1 launches, want {want} (2 per round)")
    sps = out["env_steps_per_s"][0]
    print(f"[flagship] trainer --resume {' '.join(argv)}: epoch {out['start_epoch']}, "
          f"{cfg.batch * cfg.repeats / sps * 1e3:.3f} ms/round, MSEo {mse:.3f} (clean "
          f"{out['stats']['mse_o_clean'][-1]:.3f}) against the run's last 10 epochs' median "
          f"{ref:.3f}: x{mse / ref:.3f}; top bit-unchanged, Adam steps {({k: max(v, default=0) for k, v in steps.items()})}; "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; launches {launches} "
          f"[{smi}]", flush=True)
    runs["flagship_train_resume"] = launches

    # (f) one distillation iteration and a demo round per controller.
    log = []
    LAUNCHES.clear()
    with recorded_plans(torch, log):
        res = distill_app.main(["-n", str(ROOT / FLAGSHIP), "-o", str(Path(out_root) / "flagship" / "distilled"),
                                "--iters", "1", "--distill_macro", "2", "--sweep_envs",
                                str(TRAIN_SWEEP_ENVS), "--sweep_steps",
                                str(DISTILL_SWEEP_STEPS)])
    launches = dict(LAUNCHES)
    for m in res["metrics"]:
        check(all(math.isfinite(v) for v in m.values()), f"flagship distill: metrics {m}")
    check(len(log) == 2 and launches.get("render", 0) >= 2 + 2 * DISTILL_SWEEP_STEPS,
          f"flagship distill: {len(log)} plans, {launches.get('render', 0)} K1 launches")
    reps = torch.cat([r.repeats_done for _, _, r, _ in log]).double()
    print(f"[flagship] distill: 1 iteration of 2 decisions, readouts {res['readouts']}, "
          f"metrics {({k: round(v, 4) for k, v in res['metrics'][0].items()})}, repeats_done "
          f"mean {reps.mean():.2f}; launches {launches} [{smi}]", flush=True)
    runs["flagship_distill"] = launches
    for method, flags in (("habit", []), ("ai", ["--steps", "7"]),
                          ("mcts", ["--repeats", str(DEMO_REPEATS), "--depth", "3"])):
        log = []
        LAUNCHES.clear()
        with recorded_plans(torch, log):
            out = demo_app.main(["-n", str(ROOT / FLAGSHIP), "--method", method, "--headless",
                                 str(demo_app.DURATION_OF_ROUND), *flags])
        launches = dict(LAUNCHES)
        trace = out["trace"]
        check(bool(torch.isfinite(trace).all()) and out["plans"] >= 1
              and launches.get("render", 0) == out["plans"],
              f"flagship demo {method}: {launches.get('render', 0)} K1 launches, "
              f"{out['plans']} plans")
        print(f"[flagship] demo {method}: {demo_app.DURATION_OF_ROUND} frames in "
              f"{out['wall']:.3f}s, {out['fps']:.2f} frames/s, {out['plans']} plans per round, "
              f"final score {float(trace[-1]):+.3f}; launches {launches} [{smi}]", flush=True)
        runs[f"flagship_demo_{method}"] = launches
    print(f"[flagship] phase in {time.perf_counter() - t_phase:.1f}s", flush=True)
    return runs


# ------------------------------------------------------------ slice 8
BENCH_TIMED_REPS = 1  # of each MCTS and bucketed key, and timed epochs of each training key
BENCH_TRAIN_ROUNDS = 16  # bench_train_round's rounds per epoch


def profile_env_steps(torch, lut, trace_dir) -> None:
    """The env-step key's loop, 2 x 8 steps at its 4096 envs (a warm-up run
    and a timed run of ``bench.bench_env_steps``)."""
    from deep_active_inference_mc_torch import bench

    run = lambda: bench.bench_env_steps(lut, iters=8, reps=1)
    profile_report(torch, f"bench env steps, {bench.ENV_BATCH} envs x 16 steps", run,
                   trace_dir and Path(trace_dir) / "bench_env_steps_trace.json")


def phase_bench(torch, dev, smi: str, args) -> dict:
    """The port's benchmark functions (``deep_active_inference_mc_torch/bench.py``)
    at full width, with ``bench.main``'s arguments, each MCTS, bucketed and
    training key cut to BENCH_TIMED_REPS timed runs (the warm-ups kept);
    the env-step and G keys uncut. Checks every rate finite and positive,
    every plan (``check_plan``), the trained keys present, and K1's
    launches: once per env step (ENV_ITERS x (1 + reps)), twice per
    training round, once per planner or G key (its frames). Returns K1's
    launch counts of the env-step and training keys."""
    from deep_active_inference_mc_torch import bench
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    t_phase = time.perf_counter()
    lut = raster.build_sprite_lut(dev)
    cfg = Config()
    agent = bench.build_agent(cfg, "", dev)
    agent_bf16 = bench.build_agent(cfg, "", dev, torch.bfloat16)
    trained = bench._try_load_trained_agent(dev)
    check(trained is not None, f"bench: {bench.TRAINED_CHECKPOINTS} is absent")
    R, env_reps = BENCH_TIMED_REPS, 3
    plans = bench.bench_mcts_plans
    keys = {  # key: (function, arguments, keyword arguments, K1 launches)
        "env_steps_per_sec": (bench.bench_env_steps, (lut,), {"reps": env_reps},
                              bench.ENV_ITERS * (1 + env_reps)),
        "efe_rollouts_per_sec": (bench.bench_efe_rollouts, (agent, lut), {}, 1),
        "efe_rollouts_per_sec_bf16": (bench.bench_efe_rollouts, (agent_bf16, lut), {}, 1),
        "mcts_plans_per_sec": (plans, (agent, lut), dict(repeats=50, reps=R), 1),
        "mcts_plans_per_sec_fused": (plans, (agent, lut), dict(repeats=50, fused=True, reps=R),
                                     1),
        "mcts_plans_per_sec_fused_bf16": (plans, (agent_bf16, lut),
                                          dict(repeats=50, fused=True, reps=R), 1),
        "mcts_plans_per_sec_ref_budget": (plans, (agent_bf16, lut),
                                          dict(repeats=REF_BUDGET, fused=True, reps=1), 1),
        "mcts_plans_per_sec_ref_budget_k4": (plans, (agent_bf16, lut),
                                             dict(repeats=REF_BUDGET, fused=True, reps=1,
                                                  expand_k=4), 1),
        "mcts_plans_per_sec_ref_budget_trained": (plans, (trained, lut),
                                                  dict(repeats=REF_BUDGET, fused=True, reps=R),
                                                  1),
        "mcts_plans_per_sec_ref_budget_trained_bucketed": (
            bench.bench_mcts_bucketed, (trained, lut), dict(repeats=REF_BUDGET, reps=R, B=1024),
            1),
        "mcts_plans_per_sec_ref_budget_trained_bucketed_b256": (
            bench.bench_mcts_bucketed, (trained, lut), dict(repeats=REF_BUDGET, reps=R, B=256),
            1),
        "train_env_steps_per_sec": (bench.bench_train_round, (lut,), dict(batch=512, reps=R),
                                    2 * BENCH_TRAIN_ROUNDS * (1 + R)),
        "train_env_steps_per_sec_bf16": (bench.bench_train_round, (lut,),
                                         dict(batch=512, bf16=True, reps=R),
                                         2 * BENCH_TRAIN_ROUNDS * (1 + R)),
        "train_env_steps_per_sec_b2048_bf16": (bench.bench_train_round, (lut,),
                                               dict(batch=2048, bf16=True, reps=R),
                                               2 * BENCH_TRAIN_ROUNDS * (1 + R)),
    }
    readings, runs = {}, {}
    for key, (fn, fn_args, kwargs, want) in keys.items():
        log = []
        LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_plans(torch, log):
            out = fn(*fn_args, **kwargs)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        rate = out[0] if isinstance(out, tuple) else out
        check(math.isfinite(rate) and rate > 0, f"bench {key}: rate {rate}")
        check(launches.get("render", 0) == want,
              f"bench {key}: {launches.get('render', 0)} K1 launches, want {want}")
        readings[key] = rate
        extra = ""
        if isinstance(out, tuple):
            _, cap_frac, avg = out
            check(0.0 <= cap_frac <= 1.0 and 0.0 < avg <= kwargs["repeats"],
                  f"bench {key}: cap fraction {cap_frac}, mean repeats {avg}")
            extra = f", depth cap binds {cap_frac:.4f}, mean repeats done {avg:.2f}"
            if key.endswith("ref_budget"):
                readings["mcts_depth_cap_bind_frac"] = cap_frac
            elif key.endswith("ref_budget_k4"):
                readings["mcts_depth_cap_bind_frac_k4"] = cap_frac
            elif key.endswith("trained"):
                readings["mcts_trained_avg_expansions"] = avg
        if log:
            extra += f", {len(log)} plans checked"
        print(f"[bench] {key}: {rate:.6e} in {wall:.2f}s (warm-ups included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, K1 launches "
              f"{launches.get('render', 0)}{extra} [{smi}]", flush=True)
        if key == "env_steps_per_sec" or key.startswith("train_"):
            runs[f"bench_{key}"] = launches
    print(f"[bench] readings ({BENCH_TIMED_REPS} timed run of each MCTS, bucketed and training "
          f"key; cuBLAS TF32 {torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}): {json.dumps(readings)} [{smi}]", flush=True)
    print(f"[bench] phase in {time.perf_counter() - t_phase:.1f}s", flush=True)
    if args.profile:
        profile_env_steps(torch, lut, args.trace_dir)
    return runs


def main() -> None:
    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    parser.add_argument("--profile", action="store_true",
                        help="Profile two ai macro steps after the sweep phase, two training "
                        "rounds after the training phase, two planner iterations after "
                        "the planner phase and 16 env steps after the bench phase.")
    parser.add_argument("--trace-dir", default="",
                        help="With --profile: write the chrome traces here.")
    parser.add_argument("--ladder", nargs="?", const=",".join(FULL_LADDER), default="",
                        help="Add the flagship's full ladder rows that take minutes each (all, "
                        "or a comma-separated subset of " + ", ".join(FULL_LADDER) + "), 200 "
                        "macro steps each.")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not (ROOT / PACKAGE).is_dir():
        fail(f"{PACKAGE}/ not found beside chip_smoke.py")
    if not (ROOT / FLAGSHIP / EXPORT).is_file():
        fail(f"{FLAGSHIP / EXPORT} not found: the flagship phase needs the committed export")
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
    k1, per_render = phase_render(torch, dev, bw, smi)
    LAUNCHES.clear()  # the comparison launches above do not count

    figures = {}
    with tempfile.TemporaryDirectory() as work, figure_recorders(torch, figures):
        # ---- 3. the serving path at full width ------------------------------
        sweeps = phase_sweep(torch, smi, args)
        runs = {f"sweep_{method}": r["launches"] for method, r in sweeps.items()}

        # ---- 4. the training path at full width -----------------------------
        train_runs, train_folder, f32_ms_round = phase_train(torch, smi, args, work)
        runs.update(train_runs)

        # ---- 5. card against CPU --------------------------------------------
        LAUNCHES.clear()
        phase_card_vs_cpu(torch, dev)
        phase_round_card_vs_cpu(torch, dev)

        # ---- 6. the planner path at full width ------------------------------
        phase_planner_mechanics(torch, dev)
        runs.update(phase_mcts_sweeps(torch, smi))
        LAUNCHES.clear()
        phase_reference_budget(torch, dev, smi)
        phase_search_card_vs_cpu(torch, dev)
        if args.profile:
            profile_planner(torch, dev, args.trace_dir)

        # ---- 8. MCTS-visit distillation -------------------------------------
        distill_runs, distilled = phase_distill(torch, smi, train_folder / "checkpoints",
                                                work, figures)
        runs.update(distill_runs)

        # ---- 9. the demo ----------------------------------------------------
        runs.update(phase_demo(torch, smi, distilled))

        # ---- 10. the causal trainer -----------------------------------------
        runs.update(phase_causal(torch, smi, work, figures))

        # ---- 11. bf16 forwards ----------------------------------------------
        runs.update(phase_bf16(torch, dev, smi, sweeps["ai"]["ms_macro"], f32_ms_round,
                               train_folder / "checkpoints", work))

        # ---- 12. multi-device -----------------------------------------------
        runs.update(phase_mesh(torch, dev, smi, sweeps["ai"], work))

        # ---- 13. the flagship ------------------------------------------
        runs.update(phase_flagship(torch, dev, smi, work, figures, args.ladder))

    # ---- 14. the benchmark harness ---------------------------------------
    runs.update(phase_bench(torch, dev, smi, args))

    # ---- 15. result lines ------------------------------------------------
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
        "first_design_ms": k1[main_B]["first_design_ms"],
        "first_design_route_ms": k1[main_B]["first_design_route_ms"],
        "copy_ms": k1[main_B]["copy_ms"],
        "per_call_events_ms": k1[main_B]["per_call_events_ms"],
        "launches_per_render": per_render,
        "batch": main_B,
        "launches_by_path": {path: launches.get("render", 0)
                             for path, launches in runs.items()},
        "by_batch": {str(B): v for B, v in k1.items()},
    }]
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
