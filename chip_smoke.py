#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # adds torch.profiler breakdowns of two
                                     # ai macro steps (after phase 3), of two
                                     # training rounds (after phase 4), of
                                     # two planner iterations (after phase 6)
                                     # (phase 15 profiles 16 bench env steps
                                     # either way)
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
  2b. the decoder's transposed-conv kernel (``ops/cuda/deconv.cu``) on the
     flagship's layer shapes with seeded weights and nonzero biases, at 1,
     33, 512 and 4096 rows: each layer's launch on its own input (the
     launch before's output) against ``deconv.layer_tf32``, that layer in
     float64 with the kernel's TF32 operands: beyond the half TF32 unit of
     the kernel's own rounding of its output, within FP32 summation's
     bound (2^-15 of sum |x| |w| + |bias|); the frame within
     ``deconv.FRAME_ATOL`` (2^-11) of ``decode_frames_tf32``, the whole
     stack so modelled, TF32 roundings between layers included; each beside
     its max |err| against the plain version in float64. Rows decoded alone
     bit-equal to the same rows of the 4096 batch. torch.profiler shows one
     decode as its 4 launches and a no-grad ``Decoder`` forward without
     cuDNN's dgrad or layout kernels (this check runs before phase 2, after
     which the profiler lists no device kernel in this process, with or
     without this kernel). At 512 and 4096: the decode's and each layer's
     device time with a clean L2 and no events around any call, in turns
     with the plain version (on a card, cuDNN's chain: the decoder before
     the kernel), beside the FLOP bound (495 TFLOP/s TF32) and the byte
     bound with and without the third layer's output in device memory.
  2c. the encoder's conv kernel (``ops/cuda/conv.cu``, 3 launches an
     encode) on the flagship's layer shapes with seeded weights and nonzero
     biases, at 1, 33, 512, 1024, 2048 and 4096 rows of frames half zero:
     each launch on its own input (the launch before's output) against
     ``conv.stage_tf32``, in float64 with the kernel's operands (beyond the
     half TF32 unit of its own rounding, within FP32 summation's bound);
     the flatten within ``conv.encode_tf32``'s bound; each beside its max
     |err| against the plain version in float64. The same launches'
     arithmetic with a planted fault (bf16 operands, tap (0, 0) dropped,
     the SAME pad on the leading edge), emulated in float32 with TF32 off,
     read against the same model. Rows encoded alone bit-equal to the 4096
     batch's. torch.profiler shows one encode as its 3 launches and a
     no-grad ``Encoder`` forward without cuDNN's fprop, layout or pad
     kernels (checked before phase 2, as 2b's). At 512, 1024, 2048 and
     4096: the encode's and each launch's device time with a clean L2, in
     turns with the plain version (on a card, cuDNN's chain: the encoder
     before the kernel), beside the FLOP bound (495 TFLOP/s TF32), the
     byte bounds of the function and of the launches and, at 4096, the
     0.5 ms budget.
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
     twice per training round, the epochs' rounds, the eval passes and the
     sweeps through their graphs (a capture or replays, at least one
     replay). Prints ms per round, train env-steps/s and peak device
     memory.
  5. card against CPU: env render, networks and G on 8 envs with injected
     noise, with TF32 off (then the max differences with the defaults);
     then one training round at batch 8 with injected noise: the three
     losses within 1e-4 and the three gradient norms within 1e-3
     (relative) of the CPU's.
  6. the planner path at full width, its search replaying one captured
     iteration per iteration (``make_jit_planner``; phases 8, 9, 13 and 14
     plan so too). (a) Planner mechanics on a deterministic mock of the
     model: the same roots through the planner on the CPU and on the card,
     graphed and op by op, every result field, the tree and the
     compaction schedule bit-equal (index ops, scatter-add, ties,
     compaction).
     (b) The sweep CLI's ``main`` with ``--method mcts`` at 256 envs and the
     CLI's defaults (50 repeats, simulation depth 3, max_depth 16), depth
     cut to 3 macro steps: unfused, then ``--mcts_fused``. (c) The behaviour
     ladder's best configuration, ``--mcts_bucketed --plan_queue --mcts_c
     2``, 512 envs, 6 macro steps. (d) One plan at the reference budget (300
     repeats), 256 envs, fused. (e) One search on the
     real agent, B = 8, 4 repeats, injected noise, TF32 off, card against
     CPU. Every plan is checked (scores finite, actions in range, lengths
     <= max_depth, repeats_done <= budget), and so is that it went through
     its planner's graphs (a capture or replays; the run's plans replayed
     at least once), here and in phases 8, 9, 11, 13 and 14; each run
     prints ms per macro step, plans/s, ms per planner iteration,
     repeats_done, depth_capped, peak memory, the planner's graph captures
     and replays, and K1's launches, which must equal the macro steps that
     planned.
  8. MCTS-visit distillation at full width: the distillation CLI on phase
     4's checkpoint at its defaults (256 envs, 100 repeats, expand_k 4,
     fused, batch 2048, 4 passes), depth cut to 1 iteration of 8
     decisions (2048 records: one 2048-row replay step per pass) and
     10-step habit readouts on 512 envs. Checks: every plan, mid and down
     and their Adams bit-equal to the checkpoint's, the top Adam at 4 steps
     per iteration, K1's launches = 8 per collect + 4 per iteration + one
     per readout macro step, the replay steps through their graph. Prints
     ms per collect, plans/s of the collect, the replay phase's time (its
     first step eager, the capture, then replays: 15(i) times the steps
     alone) and peak memory. Then the trainer with ``--distill_every 1 --distill_macro 2``
     for one epoch: the phase runs before the save and fills the distill
     series; its epoch, eval and replay go through their graphs.
  9. the demo: ``--headless 100`` (one round) on the distilled checkpoint
     for ``habit``, ``ai`` (7 steps, 10 samples) and ``mcts`` (300
     repeats, depth 3). Checks: a finite score trace, K1's launches = the
     plans made, every tick (and every habit and ai plan) through its
     graph. Prints frames/s and plans per round.
 10. the causal trainer CLI at batch 512 (test size 1000, 20 rounds, 2
     epochs, then ``--resume`` for a third). Checks: finite stats, F
     falling from epoch 1 to 3, 2 K1 launches per round and 2 per eval,
     the figures drawn every epoch, the rounds, the evals and the
     traversals' decode through their graphs, the resumed Adam still
     capturable. Prints ms per round and peak memory.
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
     256 envs: ``repeats_done`` beside the JAX package's, at least one
     compaction; then ``--mcts_bucketed
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
 15. graphs: phases 3, 4 and 14 (and the sweeps and rounds of 8, 11 and
     13) run their hot loops as captured CUDA graphs, the port's
     counterpart of the JAX package's jitted scans (``utils/graphs.py``),
     and the planners of 6, 8, 9, 13 and 14 replay one captured search
     iteration per iteration, the counterpart of its ``while_loop``; the
     eval passes, the causal trainer, distillation's replay and the demo's
     rounds of 4, 8, 9, 10 and 13 replay graphs too (``Graphs.call``,
     ``Graphs.scan``).
     Here each graphed path is held against its eager body from one seed.
     (a) The bench's env-step run, 4096 envs x 256 steps: the state and
     checksum bit-equal, K1's launches equal; env steps/s in turns;
     16 steps of each under torch.profiler: the graphed ones are 16 graph
     launches with K1 inside, and the busy share of both. (b) The sweep CLI's
     ``main`` with ``ai``, ``habit`` and ``ai --plan_queue --steps 2``,
     1024 envs x 20 macro steps: all scores equal (ai and habit against
     phase 3's graphed runs), ms/macro of the CLI and of a second chunk.
     (c) The trainer's epoch at 512 with the flagship's flags, 2 rounds
     from one state, float32 and bf16: losses and gradient norms within
     1e-5 relative of eager (or twice the spread of eager against eager,
     printed: cuDNN's float32 backward sums with atomics; within 1e-5 with
     cuDNN's deterministic algorithms), Adam's step
     counts equal, the largest weight difference, ms/round of 5 more
     epochs each in turns. (d) K1's launches equal on every path. (e)
     The G and training keys of the bench, eager and graphed in turns.
     (f) The planner on the committed flagship, graphed and op by op from
     one seed: one plan at the reference budget (300 repeats, fused) at
     256 envs, at 32 and at 1; one
     at the CLI's defaults (50 repeats, max_depth 16) unfused at expand_k
     4; the demo's ``mcts`` at batch 1 (``--headless 100`` at 300 repeats,
     then 10 host ticks that collect the paths); one distillation collect
     (2 decisions). With cuDNN's deterministic algorithms every result
     field (the paths too), the compaction schedules, the demo's score trace, the
     collect's records and K1's launches equal; with PyTorch's defaults
     each plan timed in turns: ms per iteration, plans/s, graphs captured,
     peak memory; the demo's frames/s; what the graph's max_depth walks
     cost (a captured walk of 1 and of 16 steps). (g)-(j) the rest of the
     JAX package's single-card compiled functions, each op by op and
     graphed from one seed (every tensor bit-equal and K1's launches equal
     with cuDNN's deterministic algorithms), then timed in turns with
     PyTorch's defaults after one untimed run each, with peak memory: (g)
     the causal epoch at batch 512 (20 rounds) and its eval at test size
     1000, ms per round and per eval pass; (h) the trainer's eval pass at
     test size 1000 on the flagship, ms per pass; (i) one distillation
     phase's replay at the CLI's defaults (20 steps of 2048 rows), ms per
     step; (j) one demo round per controller (``habit``, ``ai``, ``t1``,
     ``t12``; ``mcts`` is (f)'s) on the flagship, frames/s.
 16. one JSON line describing every hand-written kernel (K1's row at the
     training batch, the decoder kernel's at 512 and 4096, each with its
     launches by path and its registers, shared memory and local memory
     as ``cuobjdump --dump-resource-usage`` reads them from the built
     library), the card's
     ``nvidia-smi`` name and power limit, and the result line
     ``{"ok": true, "device": {...}}`` last. Imports nothing of JAX.

From phase 4 on, the port's figure functions (``viz/``) are recorders: the
card's machine has no matplotlib, PIL or scikit-learn. Each
recorder checks what it is given (finite arrays of the right shapes, frames
in [0, 1], the traversal's decoder on the card) and counts its calls.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
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
import types
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
DISTILL_ITERS = 1  # the CLI's default is 20; one keeps the script inside its time
DISTILL_MACRO = 8  # 40: 8 x 256 = 2048 records, one 2048-row replay step per pass
DISTILL_SWEEP_STEPS = 10  # the readout's default is 100
DISTILL_BATCH = 2048
DEMO_REPEATS = 300  # the demo's default
RENDER_CHECK_B = sorted({1, 33, MCTS_ENVS, TRAIN_BATCH, TRAIN_SWEEP_ENVS, LADDER_ENVS,
                         TRAIN_TEST_SIZE, SWEEP_ENVS, DISTILL_BATCH, 4096})
# B=1: the timing method's floor and the demo's batch.
RENDER_TIME_B = (1, MCTS_ENVS, TRAIN_BATCH, SWEEP_ENVS, DISTILL_BATCH, 4096)
DECONV_CHECK_B = (1, 33, TRAIN_BATCH, 4096)  # the demo, an odd size, a round's, the G sweep's rows
DECONV_TIME_B = (TRAIN_BATCH, 4096)
DECONV_LAUNCHES = 4  # per decode: one per layer
CONV_CHECK_B = (1, 33, TRAIN_BATCH, 1024, 2048, 4096)  # the demo to the habit sweep's rows
CONV_TIME_B = (TRAIN_BATCH, 1024, 2048, 4096)
CONV_LAUNCHES = 3  # per encode: layers 1-2, 3, 4
CONV_BUDGET_MS = 0.5  # an encode of 4096 rows
TF32_FLOPS = 495e12  # an H100 SXM's dense TF32 tensor-core peak (NVIDIA's data sheet)
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
    from the profiler's raw events (after a warm-up call), as the
    benchmark's tracer reads them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                if e.device_type() == DeviceType.CUDA
                                and not e.is_user_annotation())
    return sorted(names.items())


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


def deconv_work(layers, B) -> list:
    """Per layer, (FLOPs, bytes) of a decode of B rows: 2 x 9 x Cin x Cout
    per input pixel (a stride-2 phase sums only its own taps), each input
    byte read once and each output byte written once (the weights, at most
    147 KB a layer, left out)."""
    work, width = [], 16
    for layer in layers:
        cin, cout = layer.weight.shape[:2]
        s = layer.stride[0]
        work.append((2 * 9 * cin * cout * B * width * width,
                     4 * B * width * width * cin + 4 * B * (s * width) ** 2 * cout))
        width *= s
    return work


def seeded_decoder(torch, dev):
    """The flagship's decoder widths, seeded weights, nonzero biases."""
    from deep_active_inference_mc_torch.models import networks

    g = torch.Generator().manual_seed(0)
    dec = networks.Decoder()
    networks.he_uniform_init_(dec, g)
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 1:
                p.uniform_(-0.1, 0.1, generator=g)
    return dec.to(dev)


def deconv_route(torch, dev) -> None:
    """One decode is the kernel's 4 launches, and a no-grad ``Decoder``
    forward runs none of cuDNN's dgrad or layout kernels (torch.profiler).
    It runs before phase 2: phase 2 leaves later profiler sessions of the
    process without device kernels (K1's phase did so before this kernel
    existed), and a profiler entered inside inference mode listed none
    either."""
    from deep_active_inference_mc_torch.ops.cuda import deconv as k_deconv

    dec = seeded_decoder(torch, dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((TRAIN_BATCH, *k_deconv.DENSE_SHAPE), generator=g).to(dev)
    s = torch.randn((TRAIN_BATCH, 10), generator=g).to(dev)
    route = device_kernels(torch, torch.no_grad()(lambda: k_deconv.decode_frames(x, dec.deconv)))
    check(sum(c for _, c in route) == DECONV_LAUNCHES and all("deconv_" in k for k, _ in route),
          f"one decode ran {route} on the device, want {DECONV_LAUNCHES} deconv launches")
    forward = device_kernels(torch, torch.no_grad()(lambda: dec(s)))
    stray = [k for k, _ in forward if "dgrad" in k or "nhwcToNchw" in k or "nchwToNhwc" in k]
    check(not stray, f"a no-grad Decoder forward still ran {stray}")
    print(f"[deconv] one decode at B={TRAIN_BATCH}: {route}; a no-grad Decoder forward: "
          f"{forward} (torch.profiler)", flush=True)


def deconv_accuracy(torch, x, layers, launch) -> dict:
    """The decoder kernel's accuracy on NHWC ``x`` (the dense output before
    its ReLU): each layer's ``launch(h, layer, first, last)`` on its own
    input, the output of the launch before, against ``deconv.layer_tf32``
    (``layer_tf32_share``'s largest share of FP32 summation's bound) and
    against the plain version in float64 (max |err|); the frame of those
    launches against ``decode_frames_tf32`` (the share of ``FRAME_ATOL``
    used) and the plain version, beside the TF32 model's own distance from
    the plain version."""
    import copy

    from deep_active_inference_mc_torch.ops.cuda import deconv as k_deconv

    layers64 = [copy.deepcopy(layer).double() for layer in layers]
    h, per_layer = x, []
    for i, layer in enumerate(layers):
        first, last = i == 0, i == len(layers) - 1
        out = launch(h, layer, first, last)
        share = k_deconv.layer_tf32_share(out, h, layer, first, last)
        exact = k_deconv.layer_plain(h.double(), layers64[i], first, last)
        per_layer.append(dict(used=float(share.max()),
                              max_abs_err=float((out.double() - exact).abs().max())))
        del share, exact
        h = out
    exact = k_deconv.decode_frames_plain(x.double(), layers64)
    tf32 = k_deconv.decode_frames_tf32(x, layers)
    return dict(layers=per_layer,
                used=float((h.double() - tf32).abs().max()) / k_deconv.FRAME_ATOL,
                max_abs_err=float((h.double() - exact).abs().max()),
                tf32_abs_err=float((tf32 - exact).abs().max()))


def phase_deconv(torch, dev, bw: float, smi: str) -> dict:
    """The decoder's kernel against its precision's float64 model and its
    plain version; times and bounds at the timed sizes. Returns {B: its
    numbers}."""
    from deep_active_inference_mc_torch.ops.cuda import deconv as k_deconv

    g = torch.Generator().manual_seed(2)
    layers = list(seeded_decoder(torch, dev).deconv)
    l2 = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = l2.sum
    numbers = {}
    with torch.inference_mode():
        for B in DECONV_CHECK_B:
            x = torch.randn((B, *k_deconv.DENSE_SHAPE), generator=g).to(dev)
            acc = deconv_accuracy(torch, x, layers, k_deconv.layer_cuda)
            for i, a in enumerate(acc["layers"]):
                check(a["used"] <= 1.0, f"the deconv kernel at B={B}: layer {i + 1} lies "
                      f"{a['used']:.3f} x FP32 summation's bound from layer_tf32")
            check(acc["used"] <= 1.0, f"the deconv kernel at B={B}: the frame lies "
                  f"{acc['used'] * k_deconv.FRAME_ATOL:.3e} from decode_frames_tf32's, over "
                  f"FRAME_ATOL {k_deconv.FRAME_ATOL:.3e}")
            line = (f"[deconv] B={B}: each layer on its own input against layer_tf32, share of "
                    f"FP32 summation's bound used " + ", ".join(f"{a['used']:.4f}" for a in acc["layers"])
                    + "; against the plain version in float64, max |err| "
                    + ", ".join(f"{a['max_abs_err']:.3e}" for a in acc["layers"])
                    + f"; the frame against decode_frames_tf32 {acc['used']:.4f} of FRAME_ATOL "
                    f"{k_deconv.FRAME_ATOL:.3e}, against the plain version {acc['max_abs_err']:.3e}"
                    f" (the TF32 model's own {acc['tf32_abs_err']:.3e})")
            got = k_deconv.decode_frames(x, layers)
            if B == 4096:
                for i in (0, 1, 2047, 4095):
                    alone = k_deconv.decode_frames(x[i:i + 1].contiguous(), layers)
                    check(torch.equal(alone[0], got[i]), f"deconv: row {i} alone differs")
                line += "; rows 0, 1, 2047, 4095 alone bit-equal to the batch's"
            print(line, flush=True)
            if B not in DECONV_TIME_B:
                continue
            h = [x]
            for i, layer in enumerate(layers):
                h.append(k_deconv.layer_cuda(h[-1], layer, i == 0, i == len(layers) - 1))
            fns = {"kernel": lambda: k_deconv.decode_frames_cuda(x, layers)}
            for i, layer in enumerate(layers):
                fns[f"layer {i + 1}"] = (lambda i=i, layer=layer: k_deconv.layer_cuda(
                    h[i], layer, i == 0, i == len(layers) - 1))
            # The plain version on a card is cuDNN's chain, the decoder before the kernel.
            fns["plain (cuDNN)"] = lambda: k_deconv.decode_frames_plain(x, layers)
            warm_up_clocks(torch, dev)
            t = time_clean_l2_ms(torch, fns, flush)
            work = deconv_work(layers, B)
            flops = sum(f for f, _ in work)
            nbytes = sum(b for _, b in work)
            fused_bytes = nbytes - 2 * 4 * B * 64 * 64 * layers[2].weight.shape[1]
            ms, library_ms = t["kernel"][1], t["plain (cuDNN)"][1]
            bounds = dict(flops_ms=flops / TF32_FLOPS * 1e3, bytes_ms=nbytes / bw * 1e3,
                          bytes_fused_ms=fused_bytes / bw * 1e3)
            per_layer = [dict(ms=t[f"layer {i + 1}"][1], flops=f, bytes=b,
                              flops_ms=f / TF32_FLOPS * 1e3, bytes_ms=b / bw * 1e3,
                              bound_used=acc["layers"][i]["used"],
                              max_abs_err=acc["layers"][i]["max_abs_err"])
                         for i, (f, b) in enumerate(work)]
            numbers[B] = dict(max_abs_err=acc["max_abs_err"], bound_used=acc["used"], ms=ms,
                              plain_ms=library_ms, library_ms=library_ms,
                              flops=flops, bytes=nbytes, bytes_fused=fused_bytes,
                              bound_ms=max(bounds["flops_ms"], bounds["bytes_ms"]),
                              **bounds, layers=per_layer)
            spread = ", ".join(f"{k} {q[1]:.5f} ({q[0]:.5f}-{q[2]:.5f})" for k, q in t.items())
            layer_text = "; ".join(
                f"layer {i + 1} {p['ms']:.5f} ms, {p['flops'] / p['ms'] / 1e9:.1f} TFLOP/s "
                f"({p['flops_ms'] / p['ms']:.1%} of TF32), {p['bytes'] / p['ms'] / 1e9:.3f} TB/s "
                f"({p['bytes_ms'] / p['ms']:.1%} of HBM)" for i, p in enumerate(per_layer))
            print(f"[deconv] B={B}: clean L2, no events, ms per call median (min-max of "
                  f"{2 * CLEAN_L2_ROUNDS} runs of {TIMING_REPS}): {spread}; {layer_text}; "
                  f"decode {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB ({fused_bytes / 1e6:.1f}"
                  f" MB without layer 3's output in HBM): FLOP bound {bounds['flops_ms']:.5f} ms "
                  f"({bounds['flops_ms'] / ms:.1%}), byte bound {bounds['bytes_ms']:.5f} ms "
                  f"({bounds['bytes_ms'] / ms:.1%}), fused {bounds['bytes_fused_ms']:.5f} ms "
                  f"({bounds['bytes_fused_ms'] / ms:.1%}); {library_ms / ms:.2f} x "
                  f"faster than cuDNN's chain [{smi}]", flush=True)
    return numbers


def seeded_encoder(torch, dev):
    """The flagship's encoder widths, seeded weights, nonzero biases."""
    from deep_active_inference_mc_torch.models import networks

    g = torch.Generator().manual_seed(0)
    enc = networks.Encoder()
    networks.he_uniform_init_(enc, g)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 1:
                p.uniform_(-0.1, 0.1, generator=g)
    return enc.to(dev)


def encoder_frames(torch, B, g, dev):
    """Frames in [0, 1) with half their pixels 0, as sprites on a black field."""
    x = torch.rand((B, 1, 64, 64), generator=g)
    return torch.where(torch.rand(x.shape, generator=g) < 0.5, 0.0, x).to(dev)


def conv_work(B) -> dict:
    """FLOPs of an encode of B rows (2 x 9 x Cin x Cout per output pixel),
    and its bytes: the frames read and the flatten written once (the
    function), and what the three launches move (the launches)."""
    flops, width, cin = 0, 64, 1
    for cout in (32, 32, 64, 64):
        width //= 2
        flops += 2 * 9 * cin * cout * width * width * B
        cin = cout
    frame, flat = 4 * 64 * 64, 4 * 4 * 4 * 64
    h2, h3 = 4 * 16 * 16 * 32, 4 * 8 * 8 * 64
    return dict(flops=flops, bytes=B * (frame + flat),
                bytes_launched=B * (frame + 2 * h2 + 2 * h3 + flat))


def conv_route(torch, dev) -> None:
    """One encode is the kernel's 3 launches, and a no-grad ``Encoder``
    forward runs none of cuDNN's fprop, layout or the SAME pad's kernels
    (torch.profiler; before phase 2, as ``deconv_route``)."""
    from deep_active_inference_mc_torch.ops.cuda import conv as k_conv

    enc = seeded_encoder(torch, dev)
    o = encoder_frames(torch, TRAIN_BATCH, torch.Generator().manual_seed(1), dev)
    route = device_kernels(torch, torch.no_grad()(lambda: k_conv.encode_flat(o, enc.conv)))
    check(sum(c for _, c in route) == CONV_LAUNCHES and all("encoder_" in k for k, _ in route),
          f"one encode ran {route} on the device, want {CONV_LAUNCHES} conv launches")
    forward = device_kernels(torch, torch.no_grad()(lambda: enc(o)))
    stray = [k for k, _ in forward if any(n in k for n in (
        "fprop", "nchwToNhwc", "nhwcToNchw", "FillFunctor", "direct_copy"))]
    check(not stray, f"a no-grad Encoder forward still ran {stray}")
    print(f"[conv] one encode at B={TRAIN_BATCH}: {route}; a no-grad Encoder forward: "
          f"{forward} (torch.profiler)", flush=True)


def emulate_conv_stage(torch, x, layers, stage: int, fault: str):
    """One conv launch's arithmetic with a planted fault, in float32 on the
    card with TF32 off (exact products, FP32 sums), outputs rounded to TF32
    where a tensor-core layer reads them; NHWC out."""
    import torch.nn.functional as F

    from deep_active_inference_mc_torch.ops.cuda import conv as k_conv
    from deep_active_inference_mc_torch.ops.cuda import deconv as k_deconv

    pad = (1, 0, 1, 0) if fault == "leading pad" else (0, 1, 0, 1)
    x = x.bfloat16().float() if fault == "bf16" else x
    x = x if stage == 0 else x.permute(0, 3, 1, 2)
    with torch.no_grad(), tf32_off(torch):
        for i in k_conv.STAGES[stage]:
            w = layers[i].weight.detach()
            w = k_deconv.tf32_round(w) if i else w.clone()
            if fault == "bf16":
                w = w.bfloat16().float()
            elif fault == "tap":
                w[:, :, 0, 0] = 0
            x = F.relu(F.conv2d(F.pad(x, pad), w, layers[i].bias, 2))
            if i < 3:
                x = k_deconv.tf32_round(x)
    return x.permute(0, 2, 3, 1).contiguous()


def conv_accuracy(torch, o, layers, faults: bool) -> dict:
    """The encoder kernel's accuracy on frames ``o``: each launch on its
    own input against ``conv.stage_tf32`` (the largest share of its bound)
    and the plain version in float64 (max |err|); the flatten against
    ``encode_tf32`` and the plain version; with ``faults``, each planted
    fault's share per launch."""
    import copy

    from deep_active_inference_mc_torch.ops.cuda import conv as k_conv

    layers64 = copy.deepcopy(layers).double()
    x, per_stage = o, []
    for stage in range(CONV_LAUNCHES):
        out = k_conv.stage_cuda(x, layers, stage)
        row = dict(used=float(k_conv.stage_tf32_share(out, x, layers, stage).max()),
                   max_abs_err=float((out.double() - k_conv.stage_plain(
                       x.double(), layers64, stage)).abs().max()))
        if faults:
            row["faults"] = {f: float(k_conv.stage_tf32_share(
                emulate_conv_stage(torch, x, layers, stage, f), x, layers, stage).max())
                for f in ("bf16", "tap", "leading pad")}
        per_stage.append(row)
        x = out
    value, bound = k_conv.encode_tf32(o, layers)
    exact = k_conv.encode_flat_plain(o.double(), layers64)
    return dict(stages=per_stage, flat=x.reshape(o.shape[0], -1),
                used=float(k_conv.tf32_share(x.reshape(o.shape[0], -1), value, bound,
                                             rounded=False).max()),
                max_abs_err=float((x.reshape(o.shape[0], -1).double() - exact).abs().max()),
                tf32_abs_err=float((value - exact).abs().max()))


def phase_conv(torch, dev, bw: float, smi: str) -> dict:
    """The encoder's kernel against its precision's float64 model, its
    plain version and planted faults; times and bounds at the timed
    sizes. Returns {B: its numbers}."""
    from deep_active_inference_mc_torch.ops.cuda import conv as k_conv

    g = torch.Generator().manual_seed(3)
    layers = seeded_encoder(torch, dev).conv
    l2 = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = l2.sum
    numbers = {}
    with torch.inference_mode():
        for B in CONV_CHECK_B:
            o = encoder_frames(torch, B, g, dev)
            acc = conv_accuracy(torch, o, layers, faults=B in (TRAIN_BATCH, 4096))
            for i, a in enumerate(acc["stages"]):
                check(a["used"] <= 1.0, f"the conv kernel at B={B}: launch {i + 1} lies "
                      f"{a['used']:.3f} x FP32 summation's bound from stage_tf32")
                for fault, used in a.get("faults", {}).items():
                    check(used > 1.0, f"conv: the model did not flag fault {fault} in launch "
                          f"{i + 1} at B={B} ({used:.3f})")
            check(acc["used"] <= 1.0, f"the conv kernel at B={B}: the flatten lies "
                  f"{acc['used']:.3f} x encode_tf32's bound away")
            line = (f"[conv] B={B}: each launch on its own input against stage_tf32, share of "
                    f"its bound used " + ", ".join(f"{a['used']:.4f}" for a in acc["stages"])
                    + "; against the plain version in float64, max |err| "
                    + ", ".join(f"{a['max_abs_err']:.3e}" for a in acc["stages"])
                    + f"; the flatten against encode_tf32 {acc['used']:.4f} of its bound, "
                    f"against the plain version {acc['max_abs_err']:.3e} (the TF32 model's own "
                    f"{acc['tf32_abs_err']:.3e})")
            if "faults" in acc["stages"][0]:
                line += "; faults' shares by launch: " + "; ".join(
                    f"{f} " + ", ".join(f"{a['faults'][f]:.3g}" for a in acc["stages"])
                    for f in acc["stages"][0]["faults"])
            if B == 4096:
                for i in (0, 1, 2047, 4095):
                    alone = k_conv.encode_flat(o[i:i + 1].contiguous(), layers)
                    check(torch.equal(alone[0], acc["flat"][i]), f"conv: row {i} alone differs")
                line += "; rows 0, 1, 2047, 4095 alone bit-equal to the batch's"
            print(line, flush=True)
            if B not in CONV_TIME_B:
                continue
            h = [o]
            for stage in range(CONV_LAUNCHES):
                h.append(k_conv.stage_cuda(h[-1], layers, stage))
            fns = {"kernel": lambda: k_conv.encode_flat_cuda(o, layers)}
            for stage in range(CONV_LAUNCHES):
                fns[f"launch {stage + 1}"] = (lambda stage=stage: k_conv.stage_cuda(
                    h[stage], layers, stage))
            # The plain version on a card is cuDNN's chain, the encoder before the kernel.
            fns["plain (cuDNN)"] = lambda: k_conv.encode_flat_plain(o, layers)
            warm_up_clocks(torch, dev)
            t = time_clean_l2_ms(torch, fns, flush)
            work = conv_work(B)
            ms, library_ms = t["kernel"][1], t["plain (cuDNN)"][1]
            bounds = dict(flops_ms=work["flops"] / TF32_FLOPS * 1e3,
                          bytes_ms=work["bytes"] / bw * 1e3,
                          bytes_launched_ms=work["bytes_launched"] / bw * 1e3)
            numbers[B] = dict(max_abs_err=acc["max_abs_err"], bound_used=acc["used"], ms=ms,
                              plain_ms=library_ms, library_ms=library_ms,
                              launches_ms=[t[f"launch {i + 1}"][1] for i in range(CONV_LAUNCHES)],
                              bound_ms=max(bounds["flops_ms"], bounds["bytes_ms"]), **work,
                              **bounds, stages=acc["stages"])
            budget = "" if B != 4096 else (
                f"; {'within' if ms <= CONV_BUDGET_MS else 'OVER'} the {CONV_BUDGET_MS} ms budget")
            spread = ", ".join(f"{k} {q[1]:.5f} ({q[0]:.5f}-{q[2]:.5f})" for k, q in t.items())
            print(f"[conv] B={B}: clean L2, no events, ms per call median (min-max of "
                  f"{2 * CLEAN_L2_ROUNDS} runs of {TIMING_REPS}): {spread}; encode "
                  f"{work['flops'] / 1e9:.3f} GFLOP, {work['bytes'] / 1e6:.1f} MB "
                  f"({work['bytes_launched'] / 1e6:.1f} MB as launched): FLOP bound "
                  f"{bounds['flops_ms']:.5f} ms ({bounds['flops_ms'] / ms:.1%}), byte bound "
                  f"{bounds['bytes_ms']:.5f} ms ({bounds['bytes_ms'] / ms:.1%}), as launched "
                  f"{bounds['bytes_launched_ms']:.5f} ms ({bounds['bytes_launched_ms'] / ms:.1%})"
                  f", {work['flops'] / ms / 1e9:.1f} TFLOP/s; {library_ms / ms:.2f} x faster than "
                  f"cuDNN's chain{budget} [{smi}]", flush=True)
    return numbers


def phase_sweep(torch, smi: str, args) -> dict:
    """The main path through the sweep CLI, with launch counts."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

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
        check(launches.get("render", 0) == SWEEP_MACRO,
              f"{method}: {launches.get('render', 0)} render launches, want {SWEEP_MACRO}")
        decodes = 3 * SWEEP_MACRO if method == "ai" else 0  # the habit never decodes
        check(launches.get("deconv", 0) == DECONV_LAUNCHES * decodes,
              f"{method}: {launches.get('deconv', 0)} deconv launches, want "
              f"{DECONV_LAUNCHES * decodes}")
        encodes = (2 if method == "ai" else 1) * SWEEP_MACRO  # ai re-encodes G's decode
        check(launches.get("conv", 0) == CONV_LAUNCHES * encodes,
              f"{method}: {launches.get('conv', 0)} conv launches, want {CONV_LAUNCHES * encodes}")
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


def profile_report(torch, label: str, run, trace_path) -> tuple:
    """Device time by kernel and by PyTorch op over one call of ``run``
    (torch.profiler), after a warm-up call; the busy share is the device
    time over the host's wall time. Returns (device busy us, wall us, K1
    kernels run, CUDA graph launches)."""
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
    k1 = sum(e.count for e in rows if "render_frames_tma" in e.key)
    graph_launches = sum(e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CPU and "cudaGraphLaunch" in e.key)
    return busy_us, wall_us, k1, graph_launches


def profile_macro(torch, sweep_app, trace_dir) -> None:
    """Two ai macro steps of one sweep chunk, graphed as the sweep CLI runs
    them (the agent, the LUT and the capture stay outside the window)."""
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.train import sweep as sweep_lib
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    dev = torch.device("cuda")
    cfg = Config()
    agent = sweep_app.build_agent(cfg, "", dev)
    lut = raster.build_sprite_lut(dev)
    g = seeded_generator(dev, 0)
    env = env_lib.randomize(env_lib.reset(g, SWEEP_ENVS, dev), g)
    chunk = sweep_lib.make_sweep(agent, cfg, lut, method="ai", n_macro_steps=2, jumps=JUMPS)
    run = lambda: chunk(seeded_generator(dev, 1), env)
    profile_report(torch, f"ai, {SWEEP_ENVS} envs x 2 macro", run,
                   trace_dir and Path(trace_dir) / "ai_macro_trace.json")


def train_config():
    from deep_active_inference_mc_torch.config import Config

    return Config.from_args(TRAIN_FLAGS, batch=TRAIN_BATCH)


def profile_rounds(torch, trace_dir) -> None:
    """A 2-round epoch at the training phase's batch and flags, graphed as
    the trainer runs it (state, LUT and the capture outside the window;
    the window ends in the epoch's host sync)."""
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
    from deep_active_inference_mc_torch.train import loop as train_loop
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    dev = torch.device("cuda")
    cfg = train_config()
    gen = seeded_generator(dev, 0)
    state = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, dev)
    epoch = train_loop.make_epoch_fn(cfg, raster.build_sprite_lut(dev), 2)
    run = lambda: epoch(state, gen)

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
    with recorded_graphs(torch) as seen:
        first = train_app.main(argv + ["--epochs", str(TRAIN_EPOCHS)])
    launches_first = dict(LAUNCHES)
    check(first["start_epoch"] == 1, f"train: started at epoch {first['start_epoch']}")
    check_run("train", first, launches_first, TRAIN_EPOCHS)
    # The epochs' rounds, the eval passes and the sweeps replayed graphs.
    print(f"[train] {check_graphed('train', seen, ('make_epoch_fn', 'make_eval', 'make_sweep'))}",
          flush=True)
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


def card_vs_cpu_inputs(torch, network: str = ""):
    """The CPU agent (a seeded init, or ``network``'s weights) and the
    injected noise of phase 5 (seeded)."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.infer import efe

    cpu = torch.device("cpu")
    cfg = Config()
    agent = sweep_app.build_agent(cfg, network, cpu)
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


def phase_card_vs_cpu(torch, dev, network: str = "", tag: str = "card-vs-cpu") -> None:
    agent_cpu, inputs = card_vs_cpu_inputs(torch, network)
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
        print(f"[{tag}] {key} {tuple(want.shape)}: max |diff| "
              f"{(got - want).abs().max().item():.3e} with TF32 off "
              f"(rtol {tol['rtol']} atol {tol['atol']}: {'ok' if ok else 'FAIL'}); "
              f"{(loose[key].cpu() - want).abs().max().item():.3e} with the defaults "
              f"(cuDNN TF32 on)")
        check(ok, f"{tag} {key} out of tolerance")
    check(torch.equal(strict["frame"].cpu(), ref["frame"]), f"{tag}: K1 frame differs from the "
          f"CPU's")


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
    s_dim = S_DIM

    def __init__(self, torch, device, ties: bool = False):
        self.torch = torch
        self.dtype = torch.float32
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

    # What a graphed search reads of an agent: the draws it makes ahead
    # (which the model ignores) and the tensors its graph depends on.
    @property
    def mid(self):
        def draw_masks(rows, generator, device):
            return [self.torch.rand((rows, 8), generator=generator, device=device) < 0.5]
        return types.SimpleNamespace(draw_masks=draw_masks)

    def parameters(self):
        return iter(())

    def buffers(self):
        return iter((self.pi_one_hot, self.c_A, self.d_A))

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

# name: (MCTSParams fields, envs, ties)
MECHANICS_CASES = {
    "compaction": (dict(repeats=24, threshold=0.3, max_depth=16), 64, False),
    "prior": (dict(repeats=24, threshold=0.28, max_depth=16,
                   using_prior_for_exploration=True), 64, False),
    "depth_cap": (dict(repeats=14, threshold=1.1, C=0.01, max_depth=3), 16, False),
    "expand_k2": (dict(repeats=24, threshold=0.2, max_depth=16, expand_k=2), 64, False),
    "ties": (dict(repeats=8, threshold=10.0, max_depth=16), 8, True),
}


def phase_planner_mechanics(torch, dev) -> None:
    """The planner on the mock model, card (graphed, then op by op) against
    CPU: every result field, the tree and the compaction schedule equal;
    ``make_jit_planner`` equal to ``active_inference_mcts``."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    for name, (fields, B, ties) in MECHANICS_CASES.items():
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
                # The card's default is graphed; op by op beside it.
                for graphed in ((None,) if d.type == "cpu" else (None, False)):
                    plain = mcts_lib.active_inference_mcts(model, roots.to(d), p, (7,),
                                                           return_tree=True, graphed=graphed)
                    plan = mcts_lib.make_jit_planner(model, p, graphed=graphed)
                    planned = plan(roots.to(d), (7,))
                    runs[d.type if graphed is None else "card op by op"] = (
                        plain, planned, list(plan.schedule))
        cpu_plain, cpu_planned, cpu_schedule = runs["cpu"]
        for mode in (dev.type, "card op by op"):
            plain, planned, schedule = runs[mode]
            label = "card graphed" if mode == dev.type else mode
            for f in RESULT_FIELDS:
                want = getattr(cpu_plain, f)
                for what, got in ((f"{label} one-shot", getattr(plain, f)),
                                  (f"{label} planner", getattr(planned, f)),
                                  ("cpu planner", getattr(cpu_planned, f))):
                    check(torch.equal(got.cpu(), want),
                          f"planner mechanics {name}: {what} {f} differs from the CPU's one-shot")
            for f in TREE_FIELDS:
                check(torch.equal(getattr(plain.tree, f).cpu(), getattr(cpu_plain.tree, f)),
                      f"planner mechanics {name}: the {label} tree.{f} differs from the CPU's")
            check(schedule == cpu_schedule,
                  f"planner mechanics {name}: compactions {schedule} {label}, {cpu_schedule} "
                  f"on the CPU")
        plain, _, schedule = runs[dev.type]
        if name in ("compaction", "prior", "expand_k2"):
            check(len(schedule) > 0, f"planner mechanics {name}: no compaction fired")
        if name == "depth_cap":
            check(int(plain.depth_capped.sum()) > 0, "planner mechanics: no walk hit the cap")
        reps = cpu_plain.repeats_done
        print(f"[planner mechanics] {name}: {B} envs, card (graphed and op by op) == CPU and "
              f"make_jit_planner == active_inference_mcts in "
              f"{len(RESULT_FIELDS)} result fields and {len(TREE_FIELDS)} tree fields, bit for "
              f"bit; repeats_done {int(reps.min())}-{int(reps.max())}, depth_capped "
              f"{int(cpu_plain.depth_capped.sum())}, compactions (iteration, bucket) "
              f"{schedule}", flush=True)


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


def iterations(n: int):
    """``_run_search``'s ``until`` for ``n`` iterations: it is asked before
    every iteration but the first."""
    asked = itertools.count(1)
    return lambda active: next(asked) >= n


@contextlib.contextmanager
def recorded_plans(torch, log: list, require_graphs: bool = True):
    """While the block runs, every plan of the port's planner is checked
    and appended to ``log`` as (envs, seconds, result, buckets: the batch,
    then each compaction's bucket, None for a one-shot plan);
    the seconds are host time around the plan, synchronized on both sides.
    Yields a Counter of the planners' graph ``captures`` and ``replays``
    in the block. With ``require_graphs`` every plan on the card must have
    gone through its planner's graphs (a capture or a replay), the block's
    plans must have replayed at least once, and a one-shot
    ``active_inference_mcts`` (op by op by default) fails."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    counts = collections.Counter()

    def timed(plan, p, frames, graphs=None):
        before = (graphs.captures, graphs.replays) if graphs is not None else (0, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tag = f"plan {len(log)}"
        check_plan(torch, tag, res, p)
        if graphs is not None:
            counts["captures"] += graphs.captures - before[0]
            counts["replays"] += graphs.replays - before[1]
            if require_graphs:
                check(graphs.captures + graphs.replays > sum(before) or not frames.is_cuda,
                      f"{tag}: a planner built with the entry point's defaults ran op by op "
                      f"on the card")
        return res, dt

    plain = mcts_lib.active_inference_mcts
    make_jit = mcts_lib.make_jit_planner

    def plain_recorded(agent, frames, p, *a, **kw):
        check(not require_graphs, "a path planned through the one-shot active_inference_mcts "
              "where a graphed planner was expected")
        res, dt = timed(lambda: plain(agent, frames, p, *a, **kw), p, frames)
        log.append((frames.shape[0], dt, res, None))
        return res

    class JitRecorded:
        def __init__(self, agent, p, *a, **kw):
            self._plan, self._p = make_jit(agent, p, *a, **kw), p

        def __call__(self, frames, seed_path=None, draws=None):
            res, dt = timed(lambda: self._plan(frames, seed_path, draws), self._p, frames,
                            self._plan.graphs)
            log.append((frames.shape[0], dt, res,
                        [frames.shape[0]] + [size for _, size in self._plan.schedule]))
            return res

        def __getattr__(self, name):  # graphs, schedule
            return getattr(self._plan, name)

    with patched(mcts_lib, active_inference_mcts=plain_recorded, make_jit_planner=JitRecorded):
        yield counts
    if require_graphs and log:
        check(counts["replays"] > 0, f"{len(log)} plans replayed no graph ({dict(counts)})")


@contextlib.contextmanager
def recorded_graphs(torch):
    """While the block runs, every ``Graphs`` the port builds records, by
    the qualified name of the function or body it is given (``scan``,
    ``call``, ``while_loop``), its calls and the captures and replays they
    made. Yields that table."""
    from deep_active_inference_mc_torch.utils import graphs as graphs_lib

    seen = collections.defaultdict(collections.Counter)
    real = graphs_lib.Graphs

    class Recorded(real):
        def _recorded(self, method, fn, *a, **kw):
            before = (self.captures, self.replays)
            out = getattr(real, method)(self, fn, *a, **kw)
            row = seen[fn.__qualname__]
            row["calls"] += 1
            row["captures"] += self.captures - before[0]
            row["replays"] += self.replays - before[1]
            return out

        def scan(self, body, *a, **kw):
            return self._recorded("scan", body, *a, **kw)

        def call(self, fn, *a, **kw):
            return self._recorded("call", fn, *a, **kw)

        def while_loop(self, body, *a, **kw):
            return self._recorded("while_loop", body, *a, **kw)

    with patched(graphs_lib, Graphs=Recorded):
        yield seen


def check_graphed(tag: str, seen: dict, names) -> str:
    """Each of ``names`` (a part of a body's qualified name) went through
    its graphs in ``seen`` (``recorded_graphs``): called, every call
    captured or replayed; and the block replayed. Returns the rows, for
    the phase's line."""
    rows = {}
    for name in names:
        hit = collections.Counter()
        for qualname, row in seen.items():
            if name in qualname:
                hit.update(row)
        check(hit["calls"] > 0, f"{tag}: {name} never went through a graph (op by op on the "
              f"card?); graphs seen {dict(seen)}")
        check(hit["captures"] + hit["replays"] >= hit["calls"],
              f"{tag}: {name} graphs {dict(hit)}")
        rows[name] = dict(hit)
    check(sum(r["replays"] for r in rows.values()) > 0, f"{tag}: no replay in {rows}")
    return f"graphs {rows}"


def report_plans(torch, tag: str, log: list, envs: int, macro: int, wall: float, launches: dict,
                 smi: str, repeats: int = MCTS_REPEATS, graphs: dict | None = None) -> None:
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
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, launches {launches}, "
          f"planner graphs {dict(graphs or {})} [{smi}]", flush=True)
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
        with recorded_plans(torch, log) as graph_counts:
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
        report_plans(torch, tag, log, envs, macro, out["wall"], launches, smi,
                     graphs=graph_counts)
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
    """One plan at the reference's budget, fused. Printed, not asserted
    beyond the per-plan checks."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    agent, frames = planner_inputs(torch, dev, MCTS_ENVS)
    p = mcts_lib.MCTSParams(repeats=REF_BUDGET, simulation_depth=3, max_depth=MCTS_MAX_DEPTH,
                            fused_eval=True)
    plan = mcts_lib.make_jit_planner(agent, p)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan(frames, (0,))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_plan(torch, "reference budget", res, p)
    reps = res.repeats_done.double()
    print(f"[mcts] reference budget ({REF_BUDGET} repeats, fused, float32): "
          f"{MCTS_ENVS} envs, one plan in {dt:.4f}s, plans/s {MCTS_ENVS / dt:.2f}, "
          f"{dt / min(int(reps.max()) + 1, REF_BUDGET) * 1e3:.3f} ms per iteration; "
          f"repeats_done mean {reps.mean():.2f} max {int(reps.max())}, depth_capped total "
          f"{int(res.depth_capped.sum())}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, compactions (iteration, "
          f"bucket) {plan.schedule}, graphs captured {plan.graphs.captures} (capture "
          f"included) [{smi}]", flush=True)


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
            mcts_lib._run_search(agent_cpu, carry, p, iterations(1), draws=draws.iterations)
        want = mcts_lib._finalize_search(agent_cpu, carry, p)
    want_tree = carry.tree

    agent_gpu = type(agent_cpu)().to(dev)
    agent_gpu.load_state_dict(agent_cpu.state_dict())
    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    got = mcts_lib.active_inference_mcts(agent_gpu, frames.to(dev), p,
                                         draws=to_device(draws, dev), return_tree=True,
                                         graphed=True)
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
            mcts_lib._run_search(agent, carry, p, iterations(10))

            def run():
                mcts_lib._run_search(agent, carry, p, iterations(2))

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
    timings = {"collect": [], "replay": []}
    real_collect, real_replay = distill_lib.Distiller.collect, distill_lib.Distiller.replay

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
    with recorded_plans(torch, log), recorded_graphs(torch) as seen, patched(
            distill_lib.Distiller, collect=timed("collect", real_collect),
            replay=timed("replay", real_replay)):
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
    replayed = check_graphed("distill", seen, ("Distiller.replay",))
    collect_s, replay_s = timings["collect"], timings["replay"]
    plan_s = sum(dt for _, dt, _, _ in log)
    iters = sum(min(int(r.repeats_done.max()) + cfg.distill_expand_k, cfg.distill_repeats)
                // cfg.distill_expand_k for _, _, r, _ in log)
    print(f"[distill] {DISTILL_ITERS} iterations in {wall:.2f}s: collect "
          f"{statistics.mean(collect_s) * 1e3:.1f} ms each ({[round(x, 3) for x in collect_s]} "
          f"s), plans/s of the collect {n_records / statistics.mean(collect_s):.1f}, "
          f"{plan_s / max(iters, 1) * 1e3:.2f} ms per planner iteration ({iters} iterations of "
          f"{cfg.distill_expand_k} x {cfg.distill_envs} leaves); replay phase "
          f"{[round(x * 1e3, 2) for x in replay_s]} ms (graphed: {steps} steps of "
          f"{min(cfg.distill_batch, n_records)} rows, the first eager, then the capture and "
          f"{steps - 1} replays; 15(i) times the steps without the capture); readouts "
          f"{res['readouts']}; peak memory {peak / 2 ** 30:.2f} GiB; launches {launches}; "
          f"{replayed} [{smi}]", flush=True)

    # The trainer's hook: one epoch with a distill phase before the save.
    hook_macro = 2
    argv = ["--batch", str(TRAIN_BATCH), *TRAIN_FLAGS, "--test_size", str(TRAIN_TEST_SIZE),
            "--sweep_envs", str(TRAIN_SWEEP_ENVS), "--rounds", str(TRAIN_ROUNDS),
            "--sweep_steps", str(TRAIN_SWEEP_STEPS), "--save_every", "1", "--epochs", "1",
            "--distill_every", "1", "--distill_macro", str(hook_macro),
            "--out_root", str(Path(out_root) / "hook")]
    drawn = dict(figures)
    LAUNCHES.clear()
    with recorded_graphs(torch) as seen:
        out = train_app.main(argv)
    hook = dict(LAUNCHES)
    hook_graphs = check_graphed("trainer hook", seen, ("make_epoch_fn", "make_eval",
                                                       "Distiller.replay"))
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
          f"recorders {figures}; {hook_graphs} [{smi}]", flush=True)
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
        with recorded_plans(torch, log), recorded_graphs(torch) as seen:
            out = demo_app.main(["-n", str(checkpoint), "--method", method, "--headless",
                                 str(demo_app.DURATION_OF_ROUND), *flags])
        launches = dict(LAUNCHES)
        # Every tick replays a graph, and so does every habit and ai plan.
        graphed = check_graphed(f"demo {method}", seen, ("_round_tick",) + (
            () if method == "mcts" else ("Demo._plan_body",)))
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
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, launches {launches}; "
              f"{graphed} [{smi}]", flush=True)
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
    with recorded_graphs(torch) as seen:
        first = causal_app.main(argv + ["--epochs", str(TRAIN_EPOCHS)])
    launches = dict(LAUNCHES)
    # The epochs' rounds, the eval passes and the traversals' decode
    # replayed graphs.
    graphed = check_graphed("causal", seen, ("make_causal_epoch", "make_causal_eval",
                                             "StructuralCausalModel.decode"))
    LAUNCHES.clear()
    resumed = causal_app.main(argv + ["--resume", "--epochs", str(TRAIN_EPOCHS + 1)])
    launches_resumed = dict(LAUNCHES)
    check(resumed["state"].opt.param_groups[0]["capturable"],
          "causal resume: the Adam is no longer capturable")
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
          f"first pays cuDNN's algorithm search and the captures); peak memory "
          f"{peak / 2 ** 20:.1f} MiB; launches {launches} then {launches_resumed}; {graphed} "
          f"[{smi}]", flush=True)
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
    with recorded_plans(torch, log) as graph_counts:
        out = sweep_app.main(mcts + ["--macro", str(MCTS_MACRO)])
    runs["sweep_mcts_fused_bf16"] = dict(LAUNCHES)
    check(bool(torch.isfinite(out["scores"]).all()), "bf16 mcts: non-finite scores")
    check(len(log) == MCTS_MACRO and runs["sweep_mcts_fused_bf16"].get("render", 0) == MCTS_MACRO,
          "bf16 mcts: plans or K1 launches")
    report_plans(torch, "mcts_fused_bf16", log, MCTS_ENVS, MCTS_MACRO, out["wall"],
                 runs["sweep_mcts_fused_bf16"], smi, graphs=graph_counts)

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


def committed_ladder(log: Path = LADDER_LOG) -> dict:
    """label -> (mean, sem, envs) of every row of a committed ladder. A row
    is labelled by its ``method=`` field, or, where the log names its rows
    in ``# sweep method=<label>`` lines (``eval_log_round4.txt``), by that
    line."""
    rows, label = {}, None
    for line in (ROOT / log).read_text().splitlines():
        if line.startswith("# sweep method="):
            label = line.split("=", 1)[1].strip()
        elif line.startswith("method="):
            f = line.split()
            score = line.split("score: ")[1].split()
            rows[label or f[0][len("method="):]] = (
                float(score[0]), float(score[2]),
                int(next(x for x in f if x.startswith("envs="))[5:]))
            label = None
    return rows


def ladder_rows(torch, smi: str, network: Path, rows: dict, committed: dict, name: str,
                keep: dict) -> dict:
    """``rows`` (tag: (label in ``committed``, envs, the sweep CLI's flags,
    TF32 off)) through the sweep CLI on ``network`` at the committed
    protocol (seed 0, LADDER_MACRO_FULL macro steps, JUMPS jumps), each
    gated against its committed row. Returns K1's launch counts by row, and
    puts each row's result in ``keep``."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    base = ["-n", str(ROOT / network), "--seed", "0", "--jumps", str(JUMPS),
            "--macro", str(LADDER_MACRO_FULL)]
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
              f"{name} ladder {tag}: scores {tuple(scores.shape)} not all finite")
        # K1 renders once per macro step that planned (mcts), else once per
        # macro step and env group.
        groups = -(-envs // int(flags[flags.index("--env_chunk") + 1])) \
            if "--env_chunk" in flags else 1
        want = len(log) if flags[1] == "mcts" else LADDER_MACRO_FULL * groups
        check(launches.get("render", 0) == want,
              f"{name} ladder {tag}: {launches.get('render', 0)} K1 launches, want {want}")
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
        print(f"[{name}] ladder {tag}: {envs} envs x {LADDER_MACRO_FULL} macro x {JUMPS} jumps "
              f"(cuBLAS TF32 {tf32[0]}, cuDNN TF32 {tf32[1]}): {mean:+.4f} +- {sem:.4f}, "
              f"committed {mean_c:+.3f} +- {sem_c:.3f} at {envs_c} envs: {sigma:.2f} sigma "
              f"(gate {LADDER_SIGMA}); wall {out['wall']:.2f}s, "
              f"{out['wall'] / LADDER_MACRO_FULL * 1e3:.2f} ms/macro{plans}, launches {launches} "
              f"[{smi}]", flush=True)
        runs[f"{name}_ladder_{tag}"] = launches
        keep[tag] = out
    check(not misses, f"{name}: ladder rows beyond {LADDER_SIGMA} sigma of the committed "
          f"ladder: {misses}")
    return runs


def resume_phase3(torch, smi: str, network: Path, export: dict, out_root: Path,
                  name: str) -> dict:
    """The trainer's ``--resume`` on a run folder (under ``out_root``) whose
    checkpoints/ is a copy of ``network``, with the flagship run's
    config.json flags (``--gen_habit_mix 0.5 --freeze_top``: the phase-3
    workflow that made the flagship from the distilled agent), one epoch of
    TRAIN_ROUNDS rounds. Checks the epoch number, fresh Adams, ``top``
    bit-equal to ``export`` and ``mid`` and ``down`` moved, and the MSEo
    against the median of the run's last 10 epochs. Returns K1's
    launches."""
    from deep_active_inference_mc_torch.apps import train as train_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    cfg_run = json.loads((ROOT / FLAGSHIP.parent / "config.json").read_text())
    default = dataclasses.asdict(Config())
    cut = {"rounds": TRAIN_ROUNDS, "sweep_steps": TRAIN_SWEEP_STEPS, "out_root": str(out_root)}
    argv = []
    for k, v in cfg_run.items():
        v = cut.get(k, v)
        if v == default[k] or v is None or k == "epochs":
            continue
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    cfg = Config.from_args(argv)
    with open(ROOT / network / "stats.pkl", "rb") as f:
        history = pickle.load(f)
    n_done = len(history["F"])
    shutil.copytree(ROOT / network, cfg.folder_chp)
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    out = train_app.main(argv + ["--resume", "--epochs", str(n_done + 1)])
    launches = dict(LAUNCHES)
    check(out["start_epoch"] == n_done + 1, f"{name} resume: started at epoch "
          f"{out['start_epoch']}, want {n_done + 1}")
    check_stats(torch, f"{name} resume", out["stats"])
    sd = {k: v.cpu() for k, v in out["state"].agent.state_dict().items()}
    check(all(torch.equal(sd[k], v) for k, v in export["agent"].items() if k.startswith("top.")),
          f"{name} resume: top changed under freeze_top")
    still = [k for k, v in export["agent"].items()
             if k.startswith(("mid.", "down.")) and torch.equal(sd[k], v)]
    check(not still, f"{name} resume: mid / down tensors unchanged by the epoch: {still[:5]}")
    steps = {k: [int(s["step"]) for s in o.state_dict()["state"].values()]
             for k, o in out["state"].opts.items()}
    check(steps["top"] == [] and all(set(steps[k]) == {TRAIN_ROUNDS} for k in ("mid", "down")),
          f"{name} resume: Adam steps {steps}, want fresh Adams at {TRAIN_ROUNDS} (top none)")
    ref = statistics.median(history["mse_o"][-10:])
    mse = out["stats"]["mse_o"][-1]
    check(MSE_BAND[0] * ref <= mse <= MSE_BAND[1] * ref,
          f"{name} resume: MSEo {mse:.2f} outside {MSE_BAND} x {ref:.2f}")
    want = 4 * TRAIN_SWEEP_STEPS + 2 * TRAIN_ROUNDS + EVAL_RENDERS
    check(launches.get("render", 0) == want and out["round_launches"] == [2 * TRAIN_ROUNDS],
          f"{name} resume: {launches.get('render', 0)} K1 launches, want {want} (2 per round)")
    sps = out["env_steps_per_s"][0]
    print(f"[{name}] trainer --resume {' '.join(argv)}: epoch {out['start_epoch']}, "
          f"{cfg.batch * cfg.repeats / sps * 1e3:.3f} ms/round, MSEo {mse:.3f} (clean "
          f"{out['stats']['mse_o_clean'][-1]:.3f}) against the run's last 10 epochs' median "
          f"{ref:.3f}: x{mse / ref:.3f}; top bit-unchanged, mid and down moved, Adam steps "
          f"{({k: max(v, default=0) for k, v in steps.items()})}; "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; launches {launches} "
          f"[{smi}]", flush=True)
    return launches


def phase_flagship(torch, dev, smi: str, out_root: str, figures: dict, ladder: str,
                   seen: dict) -> dict:
    """The committed flagship agent through the port's CLIs, with the
    FULL_LADDER rows named in ``ladder`` (comma-separated). Returns K1's
    launch counts by path, and puts in ``seen`` what the distilled phase
    reads beside its own: the ladder rows' results, the reference-budget
    plans' statistics and the demo's ``habit`` trace."""
    import numpy as np

    from deep_active_inference_mc_torch.apps import demo as demo_app
    from deep_active_inference_mc_torch.apps import distill as distill_app
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib
    from deep_active_inference_mc_torch.train import evaluate
    from deep_active_inference_mc_torch.utils import convert

    t_phase = time.perf_counter()
    extra = [tag for tag in ladder.split(",") if tag in FULL_LADDER]
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

    # (c) ladder rows at the committed protocol: LADDER_ROWS, then the
    # FULL_LADDER rows named in ``ladder``.
    seen["ladder"] = {}
    runs.update(ladder_rows(torch, smi, FLAGSHIP,
                            dict(LADDER_ROWS, **{tag: FULL_LADDER[tag] for tag in extra}),
                            committed_ladder(), "flagship", seen["ladder"]))

    # (d) the trained-prior planner: one plan at the reference budget.
    g = torch.Generator(device=dev).manual_seed(0)
    LAUNCHES.clear()
    with torch.inference_mode():
        frames = env_lib.render(lut, env_lib.reset(g, FLAGSHIP_PLAN_ENVS, dev))
    runs["flagship_plan_frames"] = dict(LAUNCHES)
    p = mcts_lib.MCTSParams(repeats=REF_BUDGET, simulation_depth=3, max_depth=MCTS_MAX_DEPTH,
                            fused_eval=True)
    plan = mcts_lib.make_jit_planner(agent, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan(frames, (0,))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_plan(torch, "flagship plan", res, p)
    reps = res.repeats_done.double()
    check(len(plan.schedule) > 0, "flagship plan: no compaction under the trained prior")
    print(f"[flagship] plan at the reference budget ({REF_BUDGET} repeats, fused, float32): "
          f"{FLAGSHIP_PLAN_ENVS} envs in {dt:.4f}s, plans/s "
          f"{FLAGSHIP_PLAN_ENVS / dt:.2f}; repeats_done mean {reps.mean():.2f} (JAX package "
          f"{JAX_TRAINED_EXPANSIONS}/{REF_BUDGET}, BENCH_r05.json) max {int(reps.max())}, "
          f"depth_capped {int(res.depth_capped.sum())}, compactions (iteration, bucket) "
          f"{plan.schedule} [{smi}]", flush=True)
    seen["plan"] = (float(reps.mean()), int(res.depth_capped.sum()), list(plan.schedule))

    # (d) the ladder's best configuration on the trained prior, depth cut.
    log = []
    LAUNCHES.clear()
    with recorded_plans(torch, log) as graph_counts:
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
                 FLAGSHIP_QUEUE_ENVS, FLAGSHIP_QUEUE_MACRO, out["wall"], launches, smi, REF_BUDGET,
                 graphs=graph_counts)
    print(f"[flagship] bucketed queue: {compactions} compactions over {len(log)} plans; score "
          f"{out['score_mean']:+.4f} +- {out['score_sem']:.4f} after {FLAGSHIP_QUEUE_MACRO} "
          f"macro steps", flush=True)
    runs["flagship_mcts_bucketed_queue"] = launches

    # (e) the trainer resumes the flagship run with its config.json flags.
    # A run folder of its own: phase 4's run has the same signature.
    runs["flagship_train_resume"] = resume_phase3(torch, smi, FLAGSHIP, export,
                                                  Path(out_root) / "flagship", "flagship")

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
        seen[f"demo_{method}"] = trace
    print(f"[flagship] phase in {time.perf_counter() - t_phase:.1f}s", flush=True)
    return runs


# ------------------------------------------------------------ slice 12
DISTILLED = Path("artifacts") / "run512" / "checkpoints_distilled"  # the JAX CLIs' -n
LADDER_LOG_R4 = Path("artifacts") / "run512" / "eval_log_round4.txt"  # the distilled agent's
# The round-4 protocol (docs/STATUS.md, scripts/final_eval.sh's mcts and
# mcts_bucketed rows): re-plan each macro step at the reference budget,
# fused, bf16, C = 1. Added by --ladder only (each takes tens of minutes).
MCTS_R4_FLAGS = ["--method", "mcts", "--mcts_repeats", str(REF_BUDGET), "--mcts_fused", "--bf16"]
DISTILLED_ROWS = {"habit": ("habit", LADDER_ENVS_FULL, ["--method", "habit"], False)}
DISTILLED_LADDER = {
    "distilled_mcts": ("mcts", MCTS_ENVS, MCTS_R4_FLAGS + ["--chunk", "8"], False),
    "distilled_mcts_bucketed": ("mcts_bucketed", LADDER_ENVS,
                                MCTS_R4_FLAGS + ["--mcts_bucketed"], False),
}


def phase_distilled(torch, dev, smi: str, out_root: str, ladder: str, flagship: dict) -> dict:
    """The committed distilled agent (the round-4 agent the flagship was
    resumed from) through the port's CLIs, beside what phase 13 gave on
    the flagship (``flagship``: ``phase_flagship``'s ``seen``), with the
    DISTILLED_LADDER rows named in ``ladder``. Returns K1's launch counts by
    path."""
    from deep_active_inference_mc_torch.apps import demo as demo_app
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib
    from deep_active_inference_mc_torch.utils import convert

    t_phase = time.perf_counter()
    export = convert.load_export(ROOT / DISTILLED / EXPORT)
    lut = raster.build_sprite_lut(dev)
    runs = {}

    # (a) the weights on the card are the export's, bit for bit; top and
    # the precision are the flagship's, mid and down are not.
    agent = sweep_app.build_agent(Config(), str(ROOT / DISTILLED), dev)
    theirs = sweep_app.build_agent(Config(), str(ROOT / FLAGSHIP), dev)
    sd, sd_f = agent.state_dict(), theirs.state_dict()
    check(sd.keys() == export["agent"].keys(), "distilled: the agent's keys are not the export's")
    differ = [k for k, v in export["agent"].items() if not torch.equal(sd[k].cpu(), v)]
    check(not differ, f"distilled: weights differ from the export: {differ[:5]}")
    shared = sorted({k.split(".")[0] for k in sd if torch.equal(sd[k], sd_f[k])})
    check(shared == ["top"], f"distilled: parts equal to the flagship's: {shared}, want top")
    n_params = sum(v.numel() for v in sd.values())
    print(f"[distilled] {DISTILLED}: {n_params} parameters on the card equal {EXPORT}, bit for "
          f"bit; parts bit-equal to the flagship's: {shared}; precision "
          f"{({k: float(v) for k, v in export['precision'].items()})} [{smi}]", flush=True)

    # (b) the habit row at the ladder's protocol, gated against round 4's.
    keep = {}
    runs.update(ladder_rows(torch, smi, DISTILLED, DISTILLED_ROWS,
                            committed_ladder(LADDER_LOG_R4), "distilled", keep))
    mine, ref = keep["habit"]["scores"], flagship["ladder"]["habit"]["scores"]
    # The habit controller is Q(pi | encoder mean(o)): the shared top reads
    # each agent's own encoder. On the same encoder means the two habit
    # nets agree bit for bit; on frames they do not, so the rows differ.
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        o = env_lib.render(lut, env_lib.reset(g, LADDER_ENVS_FULL, dev))
        mean = agent.encode(o)[0]
        q_mine, q_ref = agent.habit(mean)[1], theirs.habit(mean)[1]
        gap = float((agent.habitual_net(o) - theirs.habitual_net(o)).abs().max())
    check(torch.equal(q_mine, q_ref), "distilled: the habit net on the same encoder means "
          "differs from the flagship's (same top, same kernels)")
    print(f"[distilled] habit row against the flagship's at seed 0 (phase 13): "
          f"{int((mine == ref).sum())} of {mine.numel()} envs score the same, mean "
          f"{float(mine.mean()):+.4f} against {float(ref.mean()):+.4f}; the habit net on the "
          f"distilled encoder's means at the row's first frames ({LADDER_ENVS_FULL}) is "
          f"bit-equal on both agents, Q(pi | frame) differs by up to {gap:.3e} (the encoders "
          f"differ) [{smi}]", flush=True)

    # (c) G and the forwards on the distilled weights, card against CPU.
    phase_card_vs_cpu(torch, dev, str(ROOT / DISTILLED), "distilled card-vs-cpu")

    # (d) one trained-prior plan at the reference budget, through the
    # planners' graphs, on phase 13's frames.
    g = torch.Generator(device=dev).manual_seed(0)
    LAUNCHES.clear()
    with torch.inference_mode():
        frames = env_lib.render(lut, env_lib.reset(g, FLAGSHIP_PLAN_ENVS, dev))
    runs["distilled_plan_frames"] = dict(LAUNCHES)
    p = mcts_lib.MCTSParams(repeats=REF_BUDGET, simulation_depth=3, max_depth=MCTS_MAX_DEPTH,
                            fused_eval=True)
    log = []
    with recorded_plans(torch, log, require_graphs=True) as graph_counts:
        plan = mcts_lib.make_jit_planner(agent, p)
        plan(frames, (0,))
    check(len(log) == 1, f"distilled plan: {len(log)} plans recorded, want 1")
    envs, dt, res, _ = log[0]
    reps = res.repeats_done.double()
    f_reps, f_capped, f_schedule = flagship["plan"]
    print(f"[distilled] plan at the reference budget ({REF_BUDGET} repeats, fused, float32): "
          f"{envs} envs in {dt:.4f}s, plans/s {envs / dt:.2f}; repeats_done mean "
          f"{reps.mean():.2f} max {int(reps.max())}, depth_capped "
          f"{int(res.depth_capped.sum())}, compactions (iteration, bucket) {plan.schedule} "
          f"(the flagship, phase 13: repeats_done mean {f_reps:.2f}, depth_capped "
          f"{f_capped}, compactions {f_schedule}); planner graphs {dict(graph_counts)} "
          f"[{smi}]", flush=True)

    # (e) the phase-3 workflow that made the flagship: the trainer resumes
    # the distilled agent with the flagship run's config.json flags.
    runs["distilled_train_resume"] = resume_phase3(torch, smi, DISTILLED, export,
                                                   Path(out_root) / "distilled", "distilled")

    # (f) a demo round per controller, habit and ai, graphed.
    for method, flags in (("habit", []), ("ai", ["--steps", "7"])):
        LAUNCHES.clear()
        with recorded_graphs(torch) as graphs_seen:
            out = demo_app.main(["-n", str(ROOT / DISTILLED), "--method", method, "--headless",
                                 str(demo_app.DURATION_OF_ROUND), *flags])
        launches = dict(LAUNCHES)
        graphed = check_graphed(f"distilled demo {method}", graphs_seen,
                                ("_round_tick", "Demo._plan_body"))
        trace = out["trace"]
        check(tuple(trace.shape) == (demo_app.DURATION_OF_ROUND,)
              and bool(torch.isfinite(trace).all()) and out["plans"] >= 1
              and launches.get("render", 0) == out["plans"],
              f"distilled demo {method}: {launches.get('render', 0)} K1 launches, "
              f"{out['plans']} plans, trace {trace}")
        ref = flagship[f"demo_{method}"]
        print(f"[distilled] demo {method}: {demo_app.DURATION_OF_ROUND} frames in "
              f"{out['wall']:.3f}s, {out['fps']:.2f} frames/s, {out['plans']} plans per round, "
              f"final score {float(trace[-1]):+.3f}; {int((trace == ref).sum())} of "
              f"{trace.numel()} ticks equal the flagship's trace (phase 13), final "
              f"{float(ref[-1]):+.3f}; launches {launches}; {graphed} [{smi}]", flush=True)
        runs[f"distilled_demo_{method}"] = launches

    # --ladder: the round-4 planner rows.
    rows = {tag: DISTILLED_LADDER[tag] for tag in ladder.split(",") if tag in DISTILLED_LADDER}
    if rows:
        runs.update(ladder_rows(torch, smi, DISTILLED, rows, committed_ladder(LADDER_LOG_R4),
                                "distilled", keep))
    print(f"[distilled] phase in {time.perf_counter() - t_phase:.1f}s", flush=True)
    return runs


# ------------------------------------------------------------ slice 8
BENCH_TIMED_REPS = 1  # of each MCTS and bucketed key, and timed epochs of each training key
BENCH_TRAIN_ROUNDS = 16  # bench_train_round's rounds per epoch


PROFILED_ENV_STEPS = 16


def profile_env_steps(torch, lut, trace_dir, graphed: bool = True) -> tuple:
    """One run of the env-step key at its 4096 envs, PROFILED_ENV_STEPS
    steps, graphed (captured in the warm-up run, so the window holds
    replays only) or op by op. Returns ``profile_report``'s readings."""
    from deep_active_inference_mc_torch import bench
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    dev = lut.device
    mode = "graphed" if graphed else "eager"
    graphs = bench._graphs(dev, graphed)
    start = env_lib.reset(seeded_generator(dev, 0), bench.ENV_BATCH, dev)

    def run():
        with torch.inference_mode():
            bench.env_step_run(lut, start, 1, PROFILED_ENV_STEPS, graphs)

    return profile_report(
        torch, f"bench env steps, {mode}, {bench.ENV_BATCH} envs x {PROFILED_ENV_STEPS} steps",
        run, trace_dir and Path(trace_dir) / f"bench_env_steps_{mode}_trace.json")


def phase_bench(torch, dev, smi: str) -> dict:
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
            plans, (trained, lut), dict(repeats=REF_BUDGET, fused=True, reps=R, batch=1024), 1),
        "mcts_plans_per_sec_ref_budget_trained_bucketed_b256": (
            plans, (trained, lut), dict(repeats=REF_BUDGET, fused=True, reps=R, batch=256), 1),
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
    return runs


# ------------------------------------------------------------ slice 9
GRAPH_ROUNDS = 2  # the round's comparison: 2 rounds from one seeded state
GRAPH_TIMED_EPOCHS = 5  # epochs of GRAPH_ROUNDS rounds each, per mode, for ms/round
GRAPH_RTOL = 1e-5  # the round's losses and norms, graphed against eager


def graphs_env_steps(torch, dev, smi: str, args) -> dict:
    """(a) The bench's env-step run, 4096 envs x 256 steps from one state
    and seed, eager and graphed: the state and checksum bit-equal, K1's
    launches equal; K1 inside the graph's replays (torch.profiler); steps/s
    of ``bench_env_steps`` in turns; the busy share of each (the device
    time per step under the profiler over the wall per step without it)."""
    from deep_active_inference_mc_torch import bench
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    lut = raster.build_sprite_lut(dev)
    B, T = bench.ENV_BATCH, bench.ENV_ITERS
    start = env_lib.reset(seeded_generator(dev, 0), B, dev)
    out, launches = {}, {}
    with torch.inference_mode():
        for mode in ("eager", "graphed"):
            graphs = bench._graphs(dev, mode == "graphed")
            LAUNCHES.clear()
            out[mode] = bench.env_step_run(lut, start, 1, T, graphs)
            torch.cuda.synchronize()
            launches[mode] = LAUNCHES.get("render", 0)
        (se, acc_e), (sg, acc_g) = out["eager"], out["graphed"]
        for f in ("latents", "score", "last_r"):
            check(torch.equal(getattr(se, f), getattr(sg, f)),
                  f"graphs: env step {f} differs between eager and graphed")
        check(torch.equal(acc_e, acc_g),
              f"graphs: env-step checksum {float(acc_e)} eager, {float(acc_g)} graphed")
        check(launches["eager"] == launches["graphed"] == T,
              f"graphs: env-step K1 launches {launches}, want {T} each")
    rates = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        rates[mode].append(bench.bench_env_steps(lut, graphed=mode == "graphed"))
    print(f"[graphs] (a) env step, {B} envs x {T} steps: state and checksum "
          f"({float(acc_g):.1f}) bit-equal, K1 launches {launches}; env_steps/s eager "
          f"{[f'{r:.4e}' for r in rates['eager']]}, graphed "
          f"{[f'{r:.4e}' for r in rates['graphed']]} [{smi}]", flush=True)
    n = PROFILED_ENV_STEPS
    for mode in ("eager", "graphed"):
        busy_us, _, traced, graph_launches = profile_env_steps(torch, lut, args.trace_dir,
                                                               mode == "graphed")
        if mode == "graphed":
            # K1 runs inside the replays. CUPTI at times drops one replay's
            # kernels from a profiler window.
            check(graph_launches == n and n - 1 <= traced <= n,
                  f"graphs: {n} replayed env steps show {traced} K1 kernels and "
                  f"{graph_launches} graph launches under torch.profiler, want {n - 1} or {n} "
                  f"and {n}")
        device_us = busy_us / traced  # one K1 kernel per traced step
        step_us = B / statistics.median(rates[mode]) * 1e6
        print(f"[graphs] (a) env step {mode}: {graph_launches} graph launches, {traced} K1 "
              f"kernels; {device_us:.1f} us of device time per step under the profiler, "
              f"{step_us:.1f} us of wall per step unprofiled: busy {device_us / step_us:.1%} "
              f"[{smi}]", flush=True)
    return {"graphs_env_step": {"render": launches["graphed"]}}


def graphs_sweeps(torch, dev, smi: str, phase3: dict) -> dict:
    """(b) The sweep CLI's ``main`` with ``ai``, ``habit`` and ``ai`` with
    the plan queue (2-step plans), 1024 envs x 20 macro steps, op by op:
    every score equal to the graphed run's (phase 3's for ai and habit),
    K1's launches too; ms/macro of the CLI (the graphed one pays its
    capture) and of a second chunk on one sweep (captured already)."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.train import sweep as sweep_lib
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    base = ["--envs", str(SWEEP_ENVS), "--jumps", str(JUMPS), "--steps", "1",
            "--samples", "1", "--seed", "0", "--macro", str(SWEEP_MACRO)]
    cases = {"ai": ["--method", "ai"], "habit": ["--method", "habit"],
             "ai+queue": ["--method", "ai", "--plan_queue", "--steps", "2"]}
    runs = {}
    for tag, flags in cases.items():
        got = {}
        for mode in ("eager", "graphed"):
            if tag in phase3 and mode == "graphed":
                got[mode] = (phase3[tag]["scores"], phase3[tag]["launches"].get("render", 0),
                             phase3[tag]["ms_macro"])
                continue
            LAUNCHES.clear()
            out = sweep_app.main(base + flags, graphed=mode == "graphed")
            got[mode] = (out["scores"].cpu(), LAUNCHES.get("render", 0),
                         out["wall"] / SWEEP_MACRO * 1e3)
        (se, le, me), (sg, lg, mg) = got["eager"], got["graphed"]
        check(torch.equal(se, sg), f"graphs: {tag} scores differ between eager and graphed "
              f"({int((se != sg).sum())} of {SWEEP_ENVS})")
        check(le == lg == SWEEP_MACRO, f"graphs: {tag} K1 launches {le} eager, {lg} graphed, "
              f"want {SWEEP_MACRO}")
        runs[f"graphs_sweep_{tag}"] = {"render": lg}
        print(f"[graphs] (b) sweep CLI {tag}: all {SWEEP_ENVS} scores equal (mean "
              f"{float(sg.double().mean()):.4f}), K1 launches {lg}; CLI ms/macro eager "
              f"{me:.3f}, graphed {mg:.3f} (its capture included) [{smi}]", flush=True)
    cfg = Config()
    agent = sweep_app.build_agent(cfg, "", dev)
    lut = raster.build_sprite_lut(dev)
    g = seeded_generator(dev, 0)
    env = env_lib.randomize(env_lib.reset(g, SWEEP_ENVS, dev), g)
    for method in ("ai", "habit"):
        ms = {}
        for mode in ("eager", "graphed", "graphed", "eager"):
            fn = sweep_lib.make_sweep(agent, cfg, lut, method=method, n_macro_steps=SWEEP_MACRO,
                                      jumps=JUMPS, graphed=mode == "graphed")
            fn(seeded_generator(dev, 1), env)  # the warm-up (and the capture)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(seeded_generator(dev, 2), env)  # ends in a host sync
            ms.setdefault(mode, []).append((time.perf_counter() - t0) / SWEEP_MACRO * 1e3)
        print(f"[graphs] (b) {method}, {SWEEP_ENVS} envs, a second {SWEEP_MACRO}-step chunk: "
              f"ms/macro eager {[round(v, 3) for v in ms['eager']]}, graphed "
              f"{[round(v, 3) for v in ms['graphed']]} [{smi}]", flush=True)
    return runs


def graphs_rounds(torch, dev, smi: str, bf16: bool) -> dict:
    """(c) The trainer's epoch at 512 with the flagship's flags, 2 rounds
    from one seeded state: eager three times (the run-to-run spread), then
    graphed. The three losses and gradient norms within GRAPH_RTOL relative
    of the eager run's (or within twice the eager runs' spread, shown), and
    within GRAPH_RTOL with cuDNN's deterministic algorithms, Adam's step
    counts equal, the largest weight difference shown, K1's launches
    equal; then ms/round of GRAPH_TIMED_EPOCHS more epochs each, in turns."""
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.train import loop as train_loop
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    cfg = dataclasses.replace(train_config(), bf16=bf16)
    lut = raster.build_sprite_lut(dev)
    dtype = torch.bfloat16 if bf16 else torch.float32
    tag = "bf16" if bf16 else "float32"
    runs = {}
    for mode in ("eager", "eager 2", "eager 3", "graphed"):
        state = train_loop.create_train_state(cfg, ActiveInferenceAgent(dtype=dtype),
                                              seeded_generator(dev, 0), dev)
        epoch = train_loop.make_epoch_fn(cfg, lut, GRAPH_ROUNDS, graphed=mode == "graphed")
        LAUNCHES.clear()
        state, metrics = epoch(state, seeded_generator(dev, 1))
        runs[mode] = dict(state=state, epoch=epoch, metrics=metrics,
                          launches=LAUNCHES.get("render", 0))
    e, gr = runs["eager"], runs["graphed"]

    def rel(a, b) -> float:
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b)

    def weights(a, b) -> float:
        with torch.no_grad():
            return max(float((x - y).abs().max())
                       for x, y in zip(a.agent.parameters(), b.agent.parameters()))

    # cuDNN's float32 backward sums with atomics: eager differs from eager
    # from round to round. The tolerance is then twice the largest spread
    # of two eager pairs.
    spread = max(rel(runs[m]["metrics"], e["metrics"]) for m in ("eager 2", "eager 3"))
    wspread = max(weights(runs[m]["state"], e["state"]) for m in ("eager 2", "eager 3"))
    diff, wdiff = rel(gr["metrics"], e["metrics"]), weights(gr["state"], e["state"])
    tol = max(GRAPH_RTOL, 2 * spread)
    check(diff <= tol, f"graphs: {tag} round's metrics differ by {diff:.3e} relative, graphed "
          f"against eager (eager against eager {spread:.3e}, tolerance {tol:.1e})")
    steps = {m: adam_steps(runs[m]["state"]) for m in runs}
    check(steps["graphed"] == steps["eager"] and set(steps["eager"].values()) == {GRAPH_ROUNDS},
          f"graphs: {tag} Adam steps {steps}")
    check(e["launches"] == gr["launches"] == 2 * GRAPH_ROUNDS,
          f"graphs: {tag} K1 launches {e['launches']} eager, {gr['launches']} graphed, want "
          f"{2 * GRAPH_ROUNDS}")
    # With cuDNN's deterministic algorithms eager equals eager, and graphed
    # must equal it too.
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = {}
        for mode in ("eager", "graphed"):
            state = train_loop.create_train_state(cfg, ActiveInferenceAgent(dtype=dtype),
                                                  seeded_generator(dev, 0), dev)
            epoch = train_loop.make_epoch_fn(cfg, lut, GRAPH_ROUNDS, graphed=mode == "graphed")
            det[mode] = epoch(state, seeded_generator(dev, 1))[1]
    finally:
        torch.backends.cudnn.deterministic = saved
    det_diff = rel(det["graphed"], det["eager"])
    check(det_diff <= GRAPH_RTOL, f"graphs: {tag} round's metrics with cuDNN deterministic "
          f"differ by {det_diff:.3e} relative, graphed against eager (tolerance {GRAPH_RTOL})")
    ms = {"eager": [], "graphed": []}
    for i in range(GRAPH_TIMED_EPOCHS):
        for mode in (("eager", "graphed") if i % 2 == 0 else ("graphed", "eager")):
            r = runs[mode]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["state"], _ = r["epoch"](r["state"], seeded_generator(dev, 2 + i))
            ms[mode].append((time.perf_counter() - t0) / GRAPH_ROUNDS * 1e3)
    print(f"[graphs] (c) round, batch {TRAIN_BATCH}, flagship flags, {tag}: {GRAPH_ROUNDS} "
          f"rounds from one state: metrics graphed vs eager max rel {diff:.3e}, eager vs eager "
          f"{spread:.3e} (tolerance {tol:.1e}), with cuDNN deterministic {det_diff:.3e} "
          f"(tolerance {GRAPH_RTOL:.0e}); largest weight difference {wdiff:.3e} (eager vs "
          f"eager {wspread:.3e}); Adam steps {steps['graphed']} both; K1 launches "
          f"{gr['launches']} both; ms/round eager {[round(v, 3) for v in ms['eager']]}, graphed "
          f"{[round(v, 3) for v in ms['graphed']]} [{smi}]", flush=True)
    return {f"graphs_round_{tag}": {"render": gr["launches"]}}


def graphs_bench_keys(torch, dev, smi: str) -> dict:
    """(e) The bench's G and training keys (``bench.py``'s protocol, the
    training keys at one timed epoch after the warm-up), op by op and
    graphed in turns: eager, graphed, graphed, eager. Returns each key's
    readings by mode."""
    from deep_active_inference_mc_torch import bench
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import raster

    lut = raster.build_sprite_lut(dev)
    agent = bench.build_agent(Config(), "", dev)
    agent_bf16 = bench.build_agent(Config(), "", dev, torch.bfloat16)
    keys = {
        "efe_rollouts_per_sec": (bench.bench_efe_rollouts, (agent, lut), {}),
        "efe_rollouts_per_sec_bf16": (bench.bench_efe_rollouts, (agent_bf16, lut), {}),
        "train_env_steps_per_sec": (bench.bench_train_round, (lut,), dict(batch=512, reps=1)),
        "train_env_steps_per_sec_bf16": (bench.bench_train_round, (lut,),
                                         dict(batch=512, bf16=True, reps=1)),
        "train_env_steps_per_sec_b2048_bf16": (bench.bench_train_round, (lut,),
                                               dict(batch=2048, bf16=True, reps=1)),
    }
    readings = {}
    for key, (fn, fn_args, kwargs) in keys.items():
        got = {"eager": [], "graphed": []}
        for mode in ("eager", "graphed", "graphed", "eager"):
            rate = fn(*fn_args, graphed=mode == "graphed", **kwargs)
            check(math.isfinite(rate) and rate > 0, f"graphs: {key} {mode} rate {rate}")
            got[mode].append(rate)
        readings[key] = got
        print(f"[graphs] (e) {key}: eager {[f'{r:.4e}' for r in got['eager']]}, graphed "
              f"{[f'{r:.4e}' for r in got['graphed']]} [{smi}]", flush=True)
    return readings


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms for the block: with its defaults
    the decoder's transposed convolutions sum with atomics, so G differs
    eager against eager in its last bits."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def same_results(torch, tag: str, got, want) -> None:
    """Every MCTSResult field bit-equal, the paths too where collected."""
    for f in RESULT_FIELDS + ("all_paths", "all_paths_G"):
        a, b = getattr(got, f), getattr(want, f)
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              f"{tag}: {f} differs graphed against op by op")


def timed_plan(torch, plan, frames, seed_path):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan(frames, seed_path)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def plan_iterations(res, p) -> int:
    """Iterations a plan ran: its slowest env's, and one more to see it."""
    n_iters = -(-p.repeats // p.expand_k)
    return min(-(-int(res.repeats_done.max()) // p.expand_k) + 1, n_iters)


def graphs_planner_turns(torch, smi: str, tag: str, make, frames, p) -> dict:
    """One plan from one seed, op by op and graphed (``make(graphed)``):
    with cuDNN's deterministic algorithms every result field and the
    compaction schedule equal; then with PyTorch's defaults in turns, graphed
    (the capture), op by op, graphed (replays only), each timed. Returns
    the ms per iteration by mode."""
    B = frames.shape[0]
    with cudnn_deterministic(torch):
        eager, graphed = make(False), make(None)
        want, _ = timed_plan(torch, eager, frames, (0,))
        got, _ = timed_plan(torch, graphed, frames, (0,))
    same_results(torch, f"planner {tag}", got, want)
    check(eager.schedule == graphed.schedule,
          f"planner {tag}: compactions {graphed.schedule} graphed, {eager.schedule} op by op")
    traces = f", compactions (iteration, bucket) {graphed.schedule}"
    iters = plan_iterations(want, p)
    times, peaks = {"graphed": [], "eager": []}, {}
    for mode, plan in (("graphed", graphed), ("eager", eager), ("graphed", graphed)):
        torch.cuda.reset_peak_memory_stats()
        res, dt = timed_plan(torch, plan, frames, (0,))
        check_plan(torch, f"planner {tag} {mode}", res, p)
        times[mode].append(dt)
        peaks[mode] = max(peaks.get(mode, 0), torch.cuda.max_memory_allocated())
    ms = {"eager": times["eager"][0] / iters * 1e3, "graphed": times["graphed"][1] / iters * 1e3}
    reps = want.repeats_done.double()
    print(f"[graphs] (f) planner, {tag}: {B} envs, every result field bit-equal graphed and op "
          f"by op (cuDNN deterministic){traces}; repeats_done mean {reps.mean():.2f} max "
          f"{int(reps.max())}, {iters} iterations; with the defaults ms per iteration eager "
          f"{ms['eager']:.3f}, graphed {ms['graphed']:.3f} ({ms['eager'] / ms['graphed']:.2f} x; "
          f"the capture's plan {times['graphed'][0] / iters * 1e3:.3f}), plans/s eager "
          f"{B / times['eager'][0]:.2f}, graphed {B / times['graphed'][1]:.2f}; graphs captured "
          f"{graphed.graphs.captures}, held {graphed.graphs.count}; peak memory eager "
          f"{peaks['eager'] / 2 ** 20:.1f} MiB, graphed {peaks['graphed'] / 2 ** 20:.1f} MiB "
          f"[{smi}]", flush=True)
    return ms


def graphs_walk_cost(torch, dev, smi: str, agent, frames, p) -> None:
    """What the graph's max_depth walks cost: one selection walk of 1 and of
    max_depth steps, each captured, on a tree 20 iterations deep, at 256,
    32 and 1 envs; a plan's early iterations walk 120 steps more than the
    eager ones (sum over i < 15 of 16 - (i + 1))."""
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib

    extra = sum(p.max_depth - (i + 1) for i in range(p.max_depth - 1))
    with torch.inference_mode():
        carry = mcts_lib._init_search(agent, frames, p, (0,))
        mcts_lib._run_search(agent, carry, p, iterations(20))
        for B in (frames.shape[0], 32, 1):
            tree = dataclasses.replace(carry.tree, **{
                f.name: getattr(carry.tree, f.name)[:B].clone()
                for f in dataclasses.fields(carry.tree)})
            ms = {}
            for steps in (1, p.max_depth):
                walk = lambda: mcts_lib._select(tree, p.C, False, p.max_depth, steps=steps)
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    walk()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    walk()
                ms[steps] = time_run_ms(torch, graph.replay, TIMING_REPS) / TIMING_REPS
            per_step = (ms[p.max_depth] - ms[1]) / (p.max_depth - 1)
            print(f"[graphs] (f) walk length, {B} envs: a captured walk of 1 step "
                  f"{ms[1]:.4f} ms, of {p.max_depth} steps {ms[p.max_depth]:.4f} ms: "
                  f"{per_step * 1e3:.2f} us per step, {extra} steps more per plan = "
                  f"{extra * per_step:.3f} ms per plan [{smi}]", flush=True)


def graphs_planner(torch, dev, smi: str) -> dict:
    """(f) The planner, graphed against op by op from one seed, on the
    committed flagship: one plan at the reference budget (300 repeats,
    fused) at 256 envs (it compacts), at 32 and at 1 env; one at the
    CLI's defaults (50 repeats, max_depth 16) unfused at expand_k 4; the
    demo's ``mcts`` at batch 1 (one headless round, then 10 host ticks,
    whose plans collect the paths); one distillation collect (2 decisions
    at the CLI's widths). Returns K1's launch counts of the graphed runs."""
    from deep_active_inference_mc_torch.apps import demo as demo_app
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.plan import mcts as mcts_lib
    from deep_active_inference_mc_torch.train import distill as distill_lib
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    agent = sweep_app.build_agent(Config(), str(ROOT / FLAGSHIP), dev)
    lut = raster.build_sprite_lut(dev)
    g = torch.Generator(device=dev).manual_seed(12)
    with torch.inference_mode():
        frames = env_lib.render(lut, env_lib.randomize(env_lib.reset(g, MCTS_ENVS, dev), g))
    ref = mcts_lib.MCTSParams(repeats=REF_BUDGET, simulation_depth=3, max_depth=MCTS_MAX_DEPTH,
                              fused_eval=True)
    cli_k4 = mcts_lib.MCTSParams(repeats=MCTS_REPEATS, simulation_depth=3,
                                 max_depth=MCTS_MAX_DEPTH, expand_k=4)
    plain = lambda p: lambda graphed: mcts_lib.make_jit_planner(agent, p, graphed=graphed)
    cases = (
        ("plain, reference budget, fused", plain(ref), frames, ref),
        ("plain, reference budget, fused, 32 envs", plain(ref), frames[:32], ref),
        ("plain, reference budget, fused, the demo's batch", plain(ref), frames[:1], ref),
        ("plain, the CLI's defaults, unfused, expand_k 4", plain(cli_k4), frames, cli_k4),
    )
    ms = {}
    for tag, make, f, p in cases:
        ms[tag] = graphs_planner_turns(torch, smi, tag, make, f, p)
    graphs_walk_cost(torch, dev, smi, agent, frames, ref)

    # The demo's mcts at batch 1: a headless round, then 10 host ticks.
    args = demo_app.build_parser().parse_args(
        ["--method", "mcts", "--repeats", str(DEMO_REPEATS), "--depth", "3"])
    demo_runs, launches = {}, {}
    for graphed in (False, None):
        log = []
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        with cudnn_deterministic(torch), recorded_plans(torch, log, graphed is not False):
            demo = demo_app.Demo(agent, args, graphed=graphed)
            out = demo_app.run_headless(demo, demo_app.DURATION_OF_ROUND)
            t0 = time.perf_counter()
            for _ in range(10):
                demo.tick()
            ticks_s = time.perf_counter() - t0
        launches[graphed] = dict(LAUNCHES)
        demo_runs[graphed] = (out, log, ticks_s, torch.cuda.max_memory_allocated(),
                              demo.planners[False].graphs.captures
                              + demo.planners[True].graphs.captures)
    (e_out, e_log, e_ticks, e_peak, _), (g_out, g_log, g_ticks, g_peak, g_caps) = (
        demo_runs[False], demo_runs[None])
    check(torch.equal(e_out["trace"], g_out["trace"]),
          "demo mcts: the score trace differs graphed against op by op")
    check(len(e_log) == len(g_log) and launches[False] == launches[None],
          f"demo mcts: {len(g_log)} plans and launches {launches[None]} graphed, {len(e_log)} "
          f"and {launches[False]} op by op")
    for i, ((_, _, a, _), (_, _, b, _)) in enumerate(zip(g_log, e_log)):
        same_results(torch, f"demo mcts plan {i}", a, b)
    paths = sum(r.all_paths is not None for _, _, r, _ in g_log)
    check(paths >= 1, "demo mcts: no host tick planned (no paths collected)")
    plan_ms = lambda log: sum(dt for _, dt, _, _ in log) / len(log) * 1e3
    iters = lambda log: sum(plan_iterations(r, demo.mcts_params) for _, _, r, _ in log)
    print(f"[graphs] (f) demo mcts, batch 1, {DEMO_REPEATS} repeats, the flagship (cuDNN "
          f"deterministic): {len(g_log)} plans ({paths} collecting the paths) bit-equal graphed "
          f"and op by op, the score trace and K1's launches ({launches[None]}) equal; frames/s "
          f"of the round eager {e_out['fps']:.2f}, graphed {g_out['fps']:.2f} (its captures "
          f"included); ms per plan eager {plan_ms(e_log):.1f}, graphed {plan_ms(g_log):.1f}; ms "
          f"per iteration eager {sum(dt for _, dt, _, _ in e_log) / iters(e_log) * 1e3:.3f}, "
          f"graphed {sum(dt for _, dt, _, _ in g_log) / iters(g_log) * 1e3:.3f}; 10 host ticks "
          f"{e_ticks:.3f} s and {g_ticks:.3f} s; graphs captured {g_caps}; peak memory eager "
          f"{e_peak / 2 ** 20:.1f} MiB, graphed {g_peak / 2 ** 20:.1f} MiB [{smi}]", flush=True)

    # One distillation collect: 2 decisions at the CLI's widths.
    cfg = Config(distill_macro=2)
    collect = {}
    for graphed in (False, None):
        log = []
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        with cudnn_deterministic(torch), recorded_plans(torch, log, graphed is not False):
            distiller = distill_lib.Distiller(agent, cfg, lut, graphed=graphed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            records = distiller.collect(seeded_generator(dev, 9))
            torch.cuda.synchronize()
            collect[graphed] = (records, log, time.perf_counter() - t0, dict(LAUNCHES),
                                torch.cuda.max_memory_allocated(), distiller.planner.graphs)
    (e_rec, e_log, e_s, e_l, e_peak, _), (g_rec, g_log, g_s, g_l, g_peak, g_graphs) = (
        collect[False], collect[None])
    check(all(torch.equal(a, b) for a, b in zip(e_rec, g_rec)) and e_l == g_l,
          f"distill collect: records or K1's launches ({g_l} graphed, {e_l} op by op) differ")
    for i, ((_, _, a, _), (_, _, b, _)) in enumerate(zip(g_log, e_log)):
        same_results(torch, f"distill collect plan {i}", a, b)
    p = distiller.mcts_params
    it = lambda log: sum(plan_iterations(r, p) for _, _, r, _ in log)
    print(f"[graphs] (f) distillation collect, {cfg.distill_envs} envs x {cfg.distill_macro} "
          f"decisions, {cfg.distill_repeats} repeats, expand_k {cfg.distill_expand_k}, fused "
          f"(cuDNN deterministic): records and {len(g_log)} plans bit-equal graphed and op by "
          f"op, K1's launches {g_l}; ms per collect eager {e_s * 1e3:.1f}, graphed "
          f"{g_s * 1e3:.1f} (its capture included); ms per iteration eager "
          f"{sum(dt for _, dt, _, _ in e_log) / it(e_log) * 1e3:.2f}, graphed "
          f"{sum(dt for _, dt, _, _ in g_log) / it(g_log) * 1e3:.2f}; graphs captured "
          f"{g_graphs.captures}; peak memory eager {e_peak / 2 ** 30:.2f} GiB, graphed "
          f"{g_peak / 2 ** 30:.2f} GiB [{smi}]", flush=True)
    return {"graphs_demo_mcts": launches[None], "graphs_distill_collect": g_l}


# ------------------------------------------------------------ slice 11
DEMO_CONTROLLERS = ("habit", "ai", "t1", "t12")  # mcts: (f)'s demo round


def in_turns(torch, runs: dict, order=("eager", "graphed", "graphed", "eager")) -> dict:
    """Each ``runs[mode]()`` once untimed (a graph captures anew under
    other backend flags), then timed on the host clock between two
    synchronizations, in turns: the seconds by mode, and each mode's peak
    memory over its timed runs."""
    for run in runs.values():
        run()
    secs, peaks = collections.defaultdict(list), {}
    for mode in order:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[mode]()
        torch.cuda.synchronize()
        secs[mode].append(time.perf_counter() - t0)
        peaks[mode] = max(peaks.get(mode, 0), torch.cuda.max_memory_allocated())
    return {"s": dict(secs), "peak_mib": {m: round(v / 2 ** 20, 1) for m, v in peaks.items()}}


def equal_or_fail(torch, tag: str, got, want) -> None:
    """Two trees of tensors (dicts, lists, tuples, dataclasses) bit-equal."""
    from deep_active_inference_mc_torch.utils import graphs as graphs_lib

    a, b = graphs_lib.leaves_of(got), graphs_lib.leaves_of(want)
    check(len(a) == len(b), f"{tag}: {len(a)} tensors graphed, {len(b)} op by op")
    for i, (x, y) in enumerate(zip(a, b)):
        check(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y),
              f"{tag}: tensor {i} ({tuple(y.shape)}) differs graphed against op by op")


def graphs_causal(torch, dev, smi: str) -> dict:
    """(g) The causal epoch at batch 512 (20 rounds) and two evals at test
    size 1000 (the second graphed one a replay), op by op and graphed from
    one seeded state: with cuDNN's deterministic algorithms the metrics,
    the evals' outputs, the weights, Adam's state and K1's launches
    bit-equal; then with PyTorch's defaults
    ms per round and per eval pass in turns (each mode's capture already
    made), and peak memory."""
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.models.causal import StructuralCausalModel
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.train import causal as causal_lib
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    cfg = Config(batch=TRAIN_BATCH, test_size=TRAIN_TEST_SIZE)
    lut = raster.build_sprite_lut(dev)

    def build(graphed):
        state = causal_lib.create_causal_state(cfg, StructuralCausalModel(),
                                               seeded_generator(dev, 0), dev)
        return dict(state=state, gen=seeded_generator(dev, 1),
                    epoch=causal_lib.make_causal_epoch(cfg, lut, TRAIN_ROUNDS, graphed),
                    eval=causal_lib.make_causal_eval(cfg, lut, graphed))

    runs, launches = {}, {}
    with cudnn_deterministic(torch):
        for mode in ("eager", "graphed"):
            r = runs[mode] = build(mode == "graphed")
            LAUNCHES.clear()
            r["state"], metrics = r["epoch"](r["state"], r["gen"])
            ev = [r["eval"](r["state"].model, r["state"].precision, r["gen"]) for _ in range(2)]
            torch.cuda.synchronize()
            launches[mode] = LAUNCHES.get("render", 0)
            r["out"] = (torch.tensor(list(metrics.values())), ev,
                        list(r["state"].model.state_dict().values()),
                        [v for st in r["state"].opt.state.values() for v in st.values()])
    equal_or_fail(torch, "causal epoch and eval", runs["graphed"]["out"], runs["eager"]["out"])
    want = 2 * TRAIN_ROUNDS + 2 * 2
    check(launches["eager"] == launches["graphed"] == want,
          f"causal: K1 launches {launches}, want {want} each (2 per round, 2 per eval)")
    check(runs["graphed"]["eval"].graphs.replays == 1,
          f"causal: {runs['graphed']['eval'].graphs.replays} eval replays, want 1")

    def epoch(mode):
        r = runs[mode]
        return lambda: r.update(state=r["epoch"](r["state"], r["gen"])[0])

    def evaluate(mode):
        r = runs[mode]
        return lambda: r["eval"](r["state"].model, r["state"].precision, r["gen"])

    t_epoch = in_turns(torch, {m: epoch(m) for m in runs})
    t_eval = in_turns(torch, {m: evaluate(m) for m in runs})
    ms_round = {m: [round(v / TRAIN_ROUNDS * 1e3, 3) for v in t] for m, t in t_epoch["s"].items()}
    ms_eval = {m: [round(v * 1e3, 3) for v in t] for m, t in t_eval["s"].items()}
    g = runs["graphed"]
    print(f"[graphs] (g) causal, batch {TRAIN_BATCH} x {TRAIN_ROUNDS} rounds and two evals at "
          f"{TRAIN_TEST_SIZE}: metrics, both evals' outputs (the second a replay), weights, "
          f"Adam's state and K1's launches ({launches['graphed']}) bit-equal graphed and op by op (cuDNN deterministic); with "
          f"the defaults ms per round {ms_round}, ms per eval pass {ms_eval}; peak memory "
          f"(epochs) {t_epoch['peak_mib']} MiB, (evals) {t_eval['peak_mib']} MiB; graphs "
          f"captured {g['epoch'].graphs.captures} + {g['eval'].graphs.captures}, replays "
          f"{g['epoch'].graphs.replays} + {g['eval'].graphs.replays} [{smi}]", flush=True)
    return {"graphs_causal": {"render": launches["graphed"]}}


def graphs_eval(torch, dev, smi: str) -> dict:
    """(h) The trainer's eval pass at test size 1000 on the committed
    flagship, op by op and graphed from one seed: with cuDNN's
    deterministic algorithms every output and K1's 5 launches bit-equal;
    then ms per pass in turns and peak memory."""
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer.precision import PrecisionState
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.train import evaluate
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    cfg = Config(test_size=TRAIN_TEST_SIZE)
    agent = sweep_app.build_agent(cfg, str(ROOT / FLAGSHIP), dev)
    lut = raster.build_sprite_lut(dev)
    precision = PrecisionState.create(0.8, device=dev)
    fns = {m: evaluate.make_eval(agent, cfg, lut, graphed=m == "graphed")
           for m in ("eager", "graphed")}
    out, launches = {}, {}
    with cudnn_deterministic(torch):
        for mode, fn in fns.items():
            LAUNCHES.clear()
            out[mode] = [fn(precision, seeded_generator(dev, 5 + i)) for i in range(2)]
            torch.cuda.synchronize()
            launches[mode] = LAUNCHES.get("render", 0)
    equal_or_fail(torch, "eval pass", out["graphed"], out["eager"])
    check(launches["eager"] == launches["graphed"] == 2 * EVAL_RENDERS,
          f"eval pass: K1 launches {launches}, want {2 * EVAL_RENDERS} each (2 passes)")
    gen = seeded_generator(dev, 7)
    t = in_turns(torch, {m: (lambda f=f: f(precision, gen)) for m, f in fns.items()})
    ms = {m: [round(v * 1e3, 3) for v in x] for m, x in t["s"].items()}
    print(f"[graphs] (h) eval pass, test size {TRAIN_TEST_SIZE}, the flagship: every output "
          f"and K1's launches ({launches['graphed']} in 2 passes) bit-equal graphed and op by "
          f"op (cuDNN deterministic); with the defaults ms per pass {ms}; peak memory "
          f"{t['peak_mib']} MiB; graphs captured {fns['graphed'].graphs.captures}, replays "
          f"{fns['graphed'].graphs.replays} [{smi}]", flush=True)
    return {"graphs_eval": {"render": launches["graphed"]}}


def graphs_replay(torch, dev, smi: str) -> dict:
    """(i) One distillation phase's replay at the CLI's defaults (256 envs
    x 40 decisions = 10240 records, batch 2048, 4 passes: 20 steps) on the
    committed flagship with seeded records, op by op and graphed from one
    seed and a fresh top Adam: with cuDNN's deterministic algorithms each
    step's F and match, the top weights, Adam's state and K1's launches
    bit-equal; then ms per replay step in turns and peak memory."""
    import copy

    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
    from deep_active_inference_mc_torch.train import distill as distill_lib
    from deep_active_inference_mc_torch.train import loop as train_loop
    from deep_active_inference_mc_torch.utils.device import seeded_generator

    cfg = Config()
    n = cfg.distill_envs * cfg.distill_macro
    steps = cfg.distill_passes * (n // cfg.distill_batch)
    base = sweep_app.build_agent(cfg, str(ROOT / FLAGSHIP), dev)
    lut = raster.build_sprite_lut(dev)
    g = seeded_generator(dev, 0)
    lat = env_lib.sample_latents(g, n, dev)
    last_r = torch.rand((n,), generator=g, device=dev) * 2 - 1
    visits = torch.randint(0, 30, (n, 4), generator=g, device=dev).float()
    log_target = torch.log(distill_lib.visit_targets(visits) + 1e-20)

    def build(graphed):
        agent = copy.deepcopy(base)
        opt = train_loop.make_optimizers(cfg, agent)["top"]
        return dict(agent=agent, opt=opt, gen=seeded_generator(dev, 1),
                    distiller=distill_lib.Distiller(agent, cfg, lut, graphed=graphed))

    runs, launches = {}, {}
    with cudnn_deterministic(torch):
        for mode in ("eager", "graphed"):
            r = runs[mode] = build(mode == "graphed")
            LAUNCHES.clear()
            table = r["distiller"].replay(r["opt"], lat, last_r, log_target, r["gen"])
            torch.cuda.synchronize()
            launches[mode] = LAUNCHES.get("render", 0)
            r["out"] = (table, list(r["agent"].top.state_dict().values()),
                        [v for st in r["opt"].state.values() for v in st.values()])
    equal_or_fail(torch, "replay", runs["graphed"]["out"], runs["eager"]["out"])
    check(launches["eager"] == launches["graphed"] == steps,
          f"replay: K1 launches {launches}, want {steps} each (1 per step)")
    table = runs["graphed"]["out"][0]

    def replay(mode):
        r = runs[mode]
        return lambda: r["distiller"].replay(r["opt"], lat, last_r, log_target, r["gen"])

    t = in_turns(torch, {m: replay(m) for m in runs})
    ms = {m: [round(v / steps * 1e3, 3) for v in x] for m, x in t["s"].items()}
    gr = runs["graphed"]["distiller"].graphs
    print(f"[graphs] (i) distillation replay, {steps} steps of {cfg.distill_batch} rows "
          f"({n} records, {cfg.distill_passes} passes), the flagship: F "
          f"{float(table[0, 0]):.4f}->{float(table[-1, 0]):.4f}, every step's F and match, the "
          f"top weights, Adam's state and K1's launches ({launches['graphed']}) bit-equal "
          f"graphed and op by op (cuDNN deterministic); with the defaults ms per replay step "
          f"{ms}; peak memory {t['peak_mib']} MiB; graphs captured {gr.captures}, replays "
          f"{gr.replays} [{smi}]", flush=True)
    return {"graphs_replay": {"render": launches["graphed"]}}


def graphs_demo_rounds(torch, dev, smi: str) -> dict:
    """(j) One demo round per controller (``habit``, ``ai``, ``t1`` and
    ``t12`` at the demo's defaults: 7 steps, 10 samples; ``mcts``: (f)) at
    batch 1 on the committed flagship, op by op and graphed from one seed:
    with cuDNN's deterministic algorithms the score trace, the final env,
    the plans and K1's launches equal; then frames/s of later rounds in
    turns and peak memory."""
    from deep_active_inference_mc_torch.apps import demo as demo_app
    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.ops.cuda import LAUNCHES

    agent = sweep_app.build_agent(Config(), str(ROOT / FLAGSHIP), dev)
    out = {}
    for method in DEMO_CONTROLLERS:
        args = demo_app.build_parser().parse_args(["--method", method])
        demos, got, launches = {}, {}, {}
        with cudnn_deterministic(torch):
            for mode in ("eager", "graphed"):
                d = demos[mode] = demo_app.Demo(agent, args,
                                                graphed=False if mode == "eager" else None)
                LAUNCHES.clear()
                trace = d.run_round()
                torch.cuda.synchronize()
                launches[mode] = LAUNCHES.get("render", 0)
                got[mode] = (trace, d.env, d.plans_made)
        equal_or_fail(torch, f"demo {method}", got["graphed"][:2], got["eager"][:2])
        plans = got["graphed"][2]
        check(got["eager"][2] == plans and launches["eager"] == launches["graphed"] == plans,
              f"demo {method}: plans {got['eager'][2]} op by op, {plans} graphed; K1 launches "
              f"{launches}")
        t = in_turns(torch, {m: d.run_round for m, d in demos.items()})
        fps = {m: [round(demo_app.DURATION_OF_ROUND / v, 2) for v in x] for m, x in t["s"].items()}
        gr = demos["graphed"].graphs
        print(f"[graphs] (j) demo {method}, batch 1, the flagship: the score trace (final "
              f"{float(got['graphed'][0][-1]):+.4f}), the env, {plans} plans and K1's launches "
              f"equal graphed and op by op (cuDNN deterministic); with the defaults frames/s "
              f"{fps}; peak memory {t['peak_mib']} MiB; graphs captured {gr.captures}, replays "
              f"{gr.replays} [{smi}]", flush=True)
        out[f"graphs_demo_{method}"] = {"render": launches["graphed"]}
    return out


def phase_graphs(torch, dev, smi: str, args, phase3: dict) -> dict:
    """Each graphed path against its eager body on the card, from one seed.
    Returns K1's launch counts of the graphed runs."""
    t_phase = time.perf_counter()
    runs = graphs_env_steps(torch, dev, smi, args)
    runs.update(graphs_sweeps(torch, dev, smi, phase3))
    for bf16 in (False, True):
        runs.update(graphs_rounds(torch, dev, smi, bf16))
    graphs_bench_keys(torch, dev, smi)
    runs.update(graphs_planner(torch, dev, smi))
    runs.update(graphs_causal(torch, dev, smi))
    runs.update(graphs_eval(torch, dev, smi))
    runs.update(graphs_replay(torch, dev, smi))
    runs.update(graphs_demo_rounds(torch, dev, smi))
    print(f"[graphs] phase in {time.perf_counter() - t_phase:.1f}s", flush=True)
    return runs


def resource_usage(build, name: str) -> list:
    """Per entry point of kernel ``name``'s built library, its registers,
    shared, local (spill) and stack memory, as ``cuobjdump
    --dump-resource-usage`` reads them."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-resource-usage", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    rows, entry = [], ""
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            entry = line[len("Function "):].rstrip(":")
        elif line.startswith("REG:"):
            rows.append(f"{entry}: {' '.join(line.split())}")
    return rows


def kernel_rows(build, k1: dict, per_render: int, dc: dict, cv: dict, runs: dict) -> list:
    """The kernels line: K1's row (its numbers at the training batch, the
    system's main path), the decoder kernel's (at 512 and 4096) and the
    encoder kernel's (512 to 4096), each with its launches by path and its
    resource usage."""
    main_B = TRAIN_BATCH
    return [{
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
        "resource_usage": resource_usage(build, "render"),
    }, {
        "name": "deconv",
        "route": "cuda",
        "source": f"{PACKAGE}/ops/cuda/deconv.cu",
        "replaces": "none: the JAX package leaves the decoder's ConvTranspose to XLA",
        "launches": runs["train"].get("deconv", 0),
        "max_abs_err": dc[main_B]["max_abs_err"],
        "ms": dc[main_B]["ms"],
        "plain_ms": dc[main_B]["plain_ms"],
        "bound_ms": dc[main_B]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": dc[main_B]["library_ms"],
        "launches_per_decode": DECONV_LAUNCHES,
        "batch": main_B,
        "launches_by_path": {path: launches.get("deconv", 0)
                             for path, launches in runs.items()},
        "by_batch": {str(B): v for B, v in dc.items()},
        "resource_usage": resource_usage(build, "deconv"),
    }, {
        "name": "conv",
        "route": "cuda",
        "source": f"{PACKAGE}/ops/cuda/conv.cu",
        "replaces": "none: the JAX package leaves the encoder's Conv to XLA",
        "launches": runs["train"].get("conv", 0),
        "max_abs_err": cv[main_B]["max_abs_err"],
        "ms": cv[main_B]["ms"],
        "plain_ms": cv[main_B]["plain_ms"],
        "bound_ms": cv[main_B]["bound_ms"],
        "bound_by": "flops",
        "library_ms": cv[main_B]["library_ms"],
        "launches_per_encode": CONV_LAUNCHES,
        "batch": main_B,
        "launches_by_path": {path: launches.get("conv", 0)
                             for path, launches in runs.items()},
        "by_batch": {str(B): {k: v for k, v in n.items() if k != "stages"}
                     for B, n in cv.items()},
        "resource_usage": resource_usage(build, "conv"),
    }]


def main() -> None:
    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    parser.add_argument("--profile", action="store_true",
                        help="Profile two ai macro steps after the sweep phase, two training "
                        "rounds after the training phase, two planner iterations after "
                        "the planner phase.")
    parser.add_argument("--trace-dir", default="",
                        help="With --profile: write the chrome traces here.")
    parser.add_argument("--ladder", nargs="?", const=",".join([*FULL_LADDER, *DISTILLED_LADDER]),
                        default="",
                        help="Add the flagship's full ladder rows and the distilled agent's "
                        "planner rows, which take minutes each (all, or a comma-separated "
                        "subset of " + ", ".join([*FULL_LADDER, *DISTILLED_LADDER]) + "), 200 "
                        "macro steps each.")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not (ROOT / PACKAGE).is_dir():
        fail(f"{PACKAGE}/ not found beside chip_smoke.py")
    for network in (FLAGSHIP, DISTILLED):
        if not (ROOT / network / EXPORT).is_file():
            fail(f"{network / EXPORT} not found: phases 13 and 13b need the committed exports")
    unknown = sorted({tag for tag in args.ladder.split(",") if tag}
                     - set(FULL_LADDER) - set(DISTILLED_LADDER))
    if unknown:
        fail(f"--ladder: no such rows {unknown} (rows: {[*FULL_LADDER, *DISTILLED_LADDER]})")
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
    deconv_route(torch, dev)  # 2b's profiler check, before phase 2 (see there)
    conv_route(torch, dev)  # 2c's, likewise
    k1, per_render = phase_render(torch, dev, bw, smi)

    # ---- 2b. the decoder's kernel against its plain version ---------------
    dc = phase_deconv(torch, dev, bw, smi)

    # ---- 2c. the encoder's kernel against its plain version ---------------
    cv = phase_conv(torch, dev, bw, smi)
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
        flagship = {}
        runs.update(phase_flagship(torch, dev, smi, work, figures, args.ladder, flagship))

        # ---- 13b. the distilled agent -----------------------------------
        runs.update(phase_distilled(torch, dev, smi, work, args.ladder, flagship))

    # ---- 14. the benchmark harness ---------------------------------------
    runs.update(phase_bench(torch, dev, smi))

    # ---- 15. graphs: each graphed path against its eager body ------------
    runs.update(phase_graphs(torch, dev, smi, args, sweeps))

    # ---- 16. result lines ------------------------------------------------
    # Every path renders through K1; the decoder's and the encoder's kernels
    # run where a path decodes or encodes without autograd in float32 with
    # TF32 allowed.
    for path, launches in runs.items():
        check(launches.get("render", 0) >= 1, f"{path}: kernel render never launched")
    for path in ("sweep_ai", "train"):
        check(runs[path].get("deconv", 0) >= DECONV_LAUNCHES,
              f"{path}: kernel deconv never launched")
    for path in ("sweep_ai", "sweep_habit", "train"):
        check(runs[path].get("conv", 0) >= CONV_LAUNCHES, f"{path}: kernel conv never launched")
    kernels = kernel_rows(build, k1, per_render, dc, cv, runs)
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
