#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of
                                     # two ai macro steps (after phase 3)
    python3 chip_smoke.py --profile --trace-dir DIR  # and its chrome trace

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name and power limit; build every CUDA kernel
     from this checkout's sources (one nvcc per source, all in parallel).
  2. kernel K1 (frame render) against its plain PyTorch version, bit for
     bit (tolerance 0) at B in {1, 33, 1024, 4096}; at 1024 and 4096 the
     device time of one call of each (median of 100 calls queued behind a
     sleep kernel, after a discarded pass of the same and a burst of work
     that raises the clocks, CUDA
     events around each call, L2 evicted before each
     call as the network passes evict it on the main path; K1's times
     with a warm L2 and with a dirty one beside them) and K1's bound
     from the bytes this data needs.
  3. the slice's main path at full width: the sweep CLI's ``main`` with the
     ``ai`` controller (mean G, 1 step, 1 sample, 5 jumps) at 1024 envs for
     20 macro steps, then ``habit``, on the seeded flagship-width agent.
     Launch counts are zeroed just before each run and read just after.
  4. card against CPU: env render, networks and G on 8 envs with injected
     noise, with TF32 off (then the max differences with the defaults).
  5. one JSON line describing every hand-written kernel, the card's
     ``nvidia-smi`` name and power limit, and the result line
     ``{"ok": true, "device": {...}}`` last. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "deep_active_inference_mc_torch"

SWEEP_ENVS = 1024
SWEEP_MACRO = 20
JUMPS = 5
RENDER_CHECK_B = (1, 33, 1024, 4096)
RENDER_TIME_B = (1024, 4096)
TIMING_REPS = 100
SLEEP_CYCLES = 400_000_000  # ~0.2 s at Hopper's clocks: covers the host's enqueue
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2
CARD_VS_CPU_ENVS = 8
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

    gen = torch.Generator(device=dev).manual_seed(1)
    lut = raster.build_sprite_lut(dev)
    # Evicting the L2 by reading a larger buffer leaves it clean; writing
    # one (zero_) leaves it dirty, and the next kernel then pays for
    # writing that buffer back. Both are timed; the clean one is K1's.
    l2 = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush, flush_dirty = l2.sum, l2.zero_
    k1 = {}
    for B in RENDER_CHECK_B:
        latents = env_lib.sample_latents(gen, B, dev)
        latents[: min(B, 2), 4:] = torch.tensor([[0, 0], [31, 31]], device=dev)[: min(B, 2)]
        last_r = torch.rand((B,), generator=gen, device=dev) * 2 - 1
        fixed = torch.tensor([0.0, -1.0, -0.3, 0.4], device=dev)[:B]
        last_r[: fixed.shape[0]] = fixed
        args = k_render.frame_inputs(latents, last_r)
        got = k_render.render_frames_cuda(lut, *args)
        want = k_render.render_frames_plain(lut, *args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.equal(got, want), f"K1 differs from its plain version at B={B}: "
              f"max |diff| {err}")
        print(f"[render] B={B}: K1 == plain, bit for bit (tolerance 0, max_abs_err {err})")
        if B not in RENDER_TIME_B:
            continue
        kernel = lambda: k_render.render_frames_cuda(lut, *args)
        plain = lambda: k_render.render_frames_plain(lut, *args)
        warm_up_clocks(torch, dev)
        t = {"K1": time_ms(torch, kernel, flush), "plain": time_ms(torch, plain, flush),
             "K1 warm L2": time_ms(torch, kernel),
             "K1 dirty L2": time_ms(torch, kernel, flush_dirty)}
        nbytes = render_bound_bytes(torch, lut, *args[:3])
        bound_ms = nbytes / bw * 1e3
        ms = t["K1"][1]
        k1[B] = dict(max_abs_err=err, ms=ms, plain_ms=t["plain"][1], bound_ms=bound_ms)
        spread = ", ".join(f"{k} {q[1]:.5f} ({q[0]:.5f}-{q[2]:.5f})" for k, q in t.items())
        print(f"[render] B={B}: ms median (quartiles): {spread}; bound {bound_ms:.5f} ms "
              f"({nbytes} B at {bw / 1e12:.2f} TB/s): K1 at {bound_ms / ms:.1%} of "
              f"bound [{smi}]", flush=True)
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


def profile_macro(torch, sweep_app, trace_dir) -> None:
    """Device time by kernel over two ai macro steps of ``run_sweep``
    (torch.profiler; the agent and LUT are built outside the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.train import sweep as sweep_lib

    dev = torch.device("cuda")
    cfg = Config()
    agent = sweep_app.build_agent(cfg, "", dev)
    lut = raster.build_sprite_lut(dev)
    run = lambda: sweep_lib.run_sweep(agent, cfg, lut, seed=0, n_envs=SWEEP_ENVS,
                                      n_macro_steps=2, method="ai", jumps=JUMPS)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] ai, {SWEEP_ENVS} envs x 2 macro under the profiler: host wall "
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
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "ai_macro_trace.json"))


def card_vs_cpu_inputs(torch):
    """The CPU agent and the injected noise of phase 4 (seeded)."""
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


def main() -> None:
    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    parser.add_argument("--profile", action="store_true",
                        help="Profile two ai macro steps after the sweep phase.")
    parser.add_argument("--trace-dir", default="",
                        help="With --profile: write the chrome trace here.")
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

    # ---- 3. the slice's main path at full width --------------------------
    runs = phase_sweep(torch, smi, args)

    # ---- 4. card against CPU ---------------------------------------------
    phase_card_vs_cpu(torch, dev)

    # ---- 5. result lines -------------------------------------------------
    main_B = SWEEP_ENVS
    kernels = [{
        "name": "render",
        "route": "cuda",
        "source": f"{PACKAGE}/ops/cuda/render.cu",
        "replaces": "deep_active_inference_mc_tpu/ops/pallas/render.py:50",
        "launches": runs["ai"]["launches"].get("render", 0),
        "max_abs_err": k1[main_B]["max_abs_err"],
        "ms": k1[main_B]["ms"],
        "plain_ms": k1[main_B]["plain_ms"],
        "bound_ms": k1[main_B]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
