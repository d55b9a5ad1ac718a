"""The frozen arithmetic: FLOP counts against PyTorch's counter, K1's bytes
against PERF.md's bound row, the trace's reduction, the import check, and
the reference's independence from the port."""

import ast
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import run
from portbench.yardstick import flops, imports, k1_bytes, seeds, trace, traffic

FLAGSHIP = run.config("dsprites-flagship")


@pytest.fixture(scope="module")
def agent():
    from portbench.drivers import common
    return common.program_agent(FLAGSHIP, torch.device("cpu"), "float32")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_parameters_of_the_widths(agent):
    assert sum(p.numel() for p in agent[1].parameters()) == FLAGSHIP["parameters"]


@pytest.mark.parametrize("method", ["ai", "habit"])
def test_macro_step_flops(agent, method):
    from deep_active_inference_mc_torch.envs import dsprites, raster
    from deep_active_inference_mc_torch.train.sweep import make_sweep
    pcfg, ag = agent
    lut = raster.build_sprite_lut("cpu")
    sweep = make_sweep(ag, pcfg, lut, method=method, n_macro_steps=1, calc_mean=True)
    g = torch.Generator().manual_seed(0)
    env = dsprites.EnvState(*traffic.episode_start(g, 3, "cpu"))
    assert _counted(lambda: sweep(g, env)) == flops.macro_step(FLAGSHIP, method, 3)


def test_train_round_flops():
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
    from deep_active_inference_mc_torch.train import loop
    flags = run.load_json(run.ROOT / run.workload("flagship-train")["flags"])
    cfg = Config(**dict(flags, batch=4))
    g = torch.Generator().manual_seed(0)
    state = loop.create_train_state(cfg, ActiveInferenceAgent(), g, "cpu")
    round_fn = loop.make_round_fn(cfg, raster.build_sprite_lut("cpu"))
    assert _counted(lambda: round_fn(state, g)) == flops.train_round(FLAGSHIP, 4)


def test_k1_bytes_reproduce_the_bound_row():
    """PERF.md's K1 table: the bound in ms at 3.35 TB/s by batch (one env
    covers 4096 LUT pixels exactly; larger batches depend on the latents,
    so within 2 %)."""
    row = {1: 0.0000098, 512: 0.00448, 1024: 0.00827, 2048: 0.01471, 4096: 0.02595}
    for B, ms in row.items():
        got = k1_bytes.bound_bytes(traffic.latents(seeds.generator("cpu", 5, B), B, "cpu"))
        assert got / 3.35e12 * 1e3 == pytest.approx(ms, rel=0.02 if B > 1 else 0.001)
    assert k1_bytes.bound_bytes(torch.tensor([[0, 1, 2, 3, 4, 5]])) == 4 * 4096 + 44 + 4 * 4096


def test_trace_reduction():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert trace.union_length(ivs) == 3.0
    assert trace.gaps(ivs, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert trace.top_by_name([("a", 1.0), ("b", 3.0), ("a", 2.5)]) == [["a", 3.5], ["b", 3.0]]


def test_pace_tells_a_stall_from_a_slowdown():
    even = run.pace([0.2] * 9 + [0.21], [False] * 10)
    assert "units: 10, median 200.000 ms" in even and "0 over 1.5 x the median" in even
    stall = run.pace([0.2] * 9 + [3.0], [False] * 5 + [True] * 3 + [False] * 2)
    assert "slowest 3000.000 ms, 1 over 1.5 x the median (3.000 s in all)" in stall
    assert "traced stretch: mean 200.000 ms over 3 units" in stall


def test_import_check():
    assert imports.forbidden_loaded(["deep_active_inference_mc_tpu.x", "jax.numpy", "jax",
                                     "optax"]) == ["deep_active_inference_mc_tpu.x", "jax",
                                                   "jax.numpy", "optax"]
    assert imports.forbidden_loaded(["deep_active_inference_mc_torch.x", "jaxtyping",
                                     "torch", "flaxen"]) == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    ref = sorted((run.BENCH / "reference").glob("*.py"))
    assert ref
    for path in ref:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top != "deep_active_inference_mc_torch" and top not in imports.FORBIDDEN, (
                path, name)


def test_benchmark_imports_nothing_of_the_jax_side():
    for path in sorted(run.BENCH.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in imports.FORBIDDEN, (path, name)


def test_readers_read_the_records_or_nothing():
    from portbench.tracing import Records
    traced = Records({"flops": 4.95e12, "window_s": 1.0, "k1_bytes_per_call": 3.35e6,
                              "efe_ms": 63.0},
                     {}, [("render_frames_tma(...)", 0.0, 2e-6), ("gemm", 0.5, 0.9)], (0.0, 1.0))
    empty = Records({}, {}, [], None)
    got = {m: run.read_metric(m, traced) for m in ("device_idle_pct.sweep", "mfu.sweep",
                                                   "k1_roofline.sweep", "efe_ms.sweep")}
    assert got["device_idle_pct.sweep"] == pytest.approx(100 * (1 - 0.400002))
    assert got["mfu.sweep"] == pytest.approx(1.0)
    assert got["k1_roofline.sweep"] == pytest.approx(50.0)
    assert got["efe_ms.sweep"] == 63.0
    for path in sorted((run.BENCH / "metrics").glob("*.py")):
        assert run.read_metric(path.stem, empty) is None, path.stem
