"""Run one benchmark cell once on one card and print one JSON line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the weights, the program's objects, warming and capturing every
shape the cell's traffic uses) runs first and is ``setup_s``: process start
to the first timed unit of work. Then the window: units of work until
``--seconds`` have passed, counted whole. Then the peak memory is read, the
program's state is freed and the plain reference (``reference/``) judges
what the window produced. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a profiled stretch
of the window (``tracing.py``, ``metrics/``). The checks print last on
standard error and, under ``checks``, last in the JSON line.

Exits non-zero with no result line when the machine lacks the cell's cards
or when the run loaded JAX or the JAX package (``yardstick/imports.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / ".portbench-cache"


def _pin_caches() -> None:
    """The program's kernel build (K1's library, ``DAIF_COMP_CACHE``) and the
    driver's JIT cache at fixed paths inside the checkout."""
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("DAIF_COMP_CACHE", "kernels")):
        os.environ[var] = str(CACHE / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def metric_specs(bench: dict, cell: str, key: str) -> List[dict]:
    """The entries of ``bench[key]`` that this cell reports: those that list
    it, and those without a list."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def read_metric(name: str, records) -> Optional[float]:
    """Run the per-layer reader ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(records)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unread"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unread"


def pace(times: List[float], traced: List[bool]) -> str:
    """The window's unit times on the host clock: a far-off run shows
    whether one unit stalled or every unit slowed, and a traced run how far
    the profiler slowed its stretch."""
    ms = sorted(1e3 * t for t in times)
    med = ms[len(ms) // 2]
    slow = [t for t in ms if t > 1.5 * med]
    out = (f"units: {len(ms)}, median {med:.3f} ms, slowest {ms[-1]:.3f} ms, "
           f"{len(slow)} over 1.5 x the median ({sum(slow) / 1e3:.3f} s in all)")
    inside = [1e3 * t for t, p in zip(times, traced) if p]
    outside = [1e3 * t for t, p in zip(times, traced) if not p]
    if inside and outside:
        out += (f"; traced stretch: mean {sum(inside) / len(inside):.3f} ms over "
                f"{len(inside)} units, {sum(outside) / len(outside):.3f} ms outside it")
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             dtype: Optional[str] = None, overrides: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of ``cell``: the result's dict, ``checks`` last. ``dtype``
    runs the program's networks in another compute dtype (the control);
    ``overrides`` replaces workload keys (small CPU runs in tests)."""
    import torch

    from portbench.tracing import Records, Tracer

    t_start = T_START if t_start is None else t_start
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = dict(workload(cell), **(overrides or {}))
    cfg = config(wl["config"])
    driver_mod = importlib.import_module(f"portbench.drivers.{wl['driver']}")
    tracer = Tracer(trace, wl["trace_seconds"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    drv = driver_mod.Driver(cfg, wl, seed, dev, tracer, dtype or cfg["dtype"])
    drv.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    times, traced = [], []
    t0 = time.perf_counter()
    while not drv.units or time.perf_counter() - t0 < seconds:
        tracer.boundary(time.perf_counter() - t0, seconds)
        t = time.perf_counter()
        drv.unit()
        times.append(time.perf_counter() - t)
        traced.append(tracer.profiling)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    tracer.finish()
    work_s = window_s - tracer.paused_s

    extras = drv.trace_extras() if trace else {}
    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    e2e = drv.end_to_end(window_s)
    e2e["setup_s"] = setup_s
    counters = dict(tracer.counters, window_s=work_s, **extras)
    drv.release()
    checks = drv.check()

    result: Dict = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
                    "attempted": drv.attempted, "failed": drv.failed}
    if trace:
        records = Records(counters, dict(tracer.spans), tracer.kernels, tracer.stretch)
        metrics = {}
        for m in metric_specs(bench, cell, "per_layer"):
            v = read_metric(m["name"], records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metric_specs(bench, cell, "end_to_end")}
    result["metrics"] = metrics
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": wl["chips"] if dev.type == "cuda" else 0,
            "memory_peak_bytes": int(peak)}
    if trace:
        digest = tracer.digest()
        result["trace_summary"] = tracer.summary
        info["busy_s"], info["window_s"] = digest["busy_s"], digest["window_s"]
        result["breakdown"] = {"device_ops": digest["device_ops"],
                               "idle_gaps": digest["idle_gaps"]}
    result["device"] = info
    result["detail"] = f"{getattr(drv, 'detail', '')}\nwindow: {pace(times, traced)}"
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _pin_caches()
    import torch

    from portbench.yardstick.imports import forbidden_loaded

    chips = workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in (result.pop("trace_summary", ""), result.pop("detail", "")):
        if line:
            print(line, file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
