"""PyTorch port: the span registry (``utils/profiling.py``) and the spans at
the port's layer boundaries.

On the CPU: nesting, parents and self time; the ring's bound and the
totals that outlive it; parents per thread; no ``record_function`` while
no profiler runs, and under a CPU profiler every span an annotation of its
name on the registry's clock; the op-by-op epoch and sweep's spans. Tests
marked ``cuda`` (a graphed scan's warm-up, capture and replays; a kernel
inside a span's interval on the device trace's clock; the ``ai`` sweep's G
timed inside its graph) skip without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_profiling.py
"""

import threading
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.train import loop as tloop
from deep_active_inference_mc_torch.train import sweep as tsweep
from deep_active_inference_mc_torch.utils import graphs, profiling
from deep_active_inference_mc_torch.utils.device import seeded_generator

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def registry():
    profiling.reset()
    yield
    profiling.reset()


def by_name(name):
    return [s for s in profiling.spans() if s.name == name]


def annotations(prof):
    """(name, start ns, end ns) of the profiler's user annotations."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def test_nesting_parents_and_self_time():
    with profiling.span("outer"):
        time.sleep(0.002)
        with profiling.span("inner"):
            time.sleep(0.003)
        with profiling.span("inner"):
            with profiling.span("leaf"):
                time.sleep(0.001)
    (outer,) = by_name("outer")
    inner = by_name("inner")
    (leaf,) = by_name("leaf")
    assert outer.parent is None and [s.parent for s in inner] == ["outer"] * 2
    assert leaf.parent == "inner"
    # A span's ring position is its end: children before their parent.
    assert [s.name for s in profiling.spans()] == ["inner", "leaf", "inner", "outer"]
    for s in profiling.spans():
        assert s.start_ns <= s.end_ns and s.thread == threading.get_ident()
    assert outer.start_ns <= inner[0].start_ns and inner[1].end_ns <= outer.end_ns
    child = sum(s.end_ns - s.start_ns for s in inner)
    assert outer.self_ns == outer.end_ns - outer.start_ns - child
    assert outer.self_ns >= 2e6 and leaf.self_ns >= 1e6
    assert inner[1].self_ns == inner[1].end_ns - inner[1].start_ns - (leaf.end_ns - leaf.start_ns)
    t = profiling.totals()
    assert t["inner"].count == 2 and t["outer"].count == 1
    assert t["inner"].total_ns == child
    assert t["inner"].self_ns == sum(s.self_ns for s in inner)


def test_spanned_is_a_span_per_call_and_record_device_a_span_of_no_thread():
    @profiling.spanned("deco")
    def f(x):
        """doc"""
        with profiling.span("in_f"):
            return x + 1

    assert f(1) == 2 and f(2) == 3 and f.__doc__ == "doc" and f.__name__ == "f"
    assert [s.parent for s in by_name("in_f")] == ["deco", "deco"]
    profiling.record_device("dev", 0.0125)
    (d,) = by_name("dev")
    assert d.thread is None and d.parent is None
    assert d.end_ns - d.start_ns == d.self_ns == 12_500_000
    assert profiling.totals()["deco"].count == 2


def test_ring_keeps_the_last_spans_and_totals_outlive_it():
    for name, n in (("early", 1000), ("late", profiling.RING)):
        for _ in range(n):
            with profiling.span(name):
                pass
    kept = profiling.spans()
    assert len(kept) == profiling.RING and {s.name for s in kept} == {"late"}
    assert all(a.end_ns <= b.end_ns for a, b in zip(kept, kept[1:]))
    t = profiling.totals()
    assert t["early"].count == 1000 and t["late"].count == profiling.RING
    assert t["late"].total_ns == sum(s.end_ns - s.start_ns for s in kept)
    profiling.reset()
    assert profiling.spans() == [] and profiling.totals() == {}


def test_parents_are_per_thread():
    seen = {}

    def worker():
        with profiling.span("worker"):
            with profiling.span("worker.inner"):
                seen["ident"] = threading.get_ident()

    with profiling.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    (w,) = by_name("worker")
    (wi,) = by_name("worker.inner")
    (m,) = by_name("main")
    assert w.parent is None and wi.parent == "worker"
    assert w.thread == wi.thread == seen["ident"] != m.thread
    # The other thread's span is not the main span's child.
    assert m.self_ns == m.end_ns - m.start_ns


def test_no_record_function_while_no_profiler_runs(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    for _ in range(10):
        with profiling.span("quiet"):
            pass
    assert entered == [] and profiling.totals()["quiet"].count == 10
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("loud"):
            pass
    assert entered == ["loud"]


def test_spans_are_annotations_on_the_registry_clock_under_a_cpu_profiler():
    a = torch.ones(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # A process's first annotation takes a millisecond or more to enter
        # (the benchmark's first is its stretch's).
        with torch.autograd.profiler.record_function("first"):
            pass
        with profiling.span("port.outer"):
            with profiling.span("port.inner"):
                for _ in range(20):
                    a = a @ a / 128
            time.sleep(0.002)
    marks = {n: (s, e) for n, s, e in annotations(prof)}
    assert len(profiling.spans()) == 2
    for s in profiling.spans():
        lo, hi = marks[s.name]
        assert abs(lo - s.start_ns) < 200_000 and abs(hi - s.end_ns) < 200_000, s.name
        assert s.start_ns <= lo and hi <= s.end_ns  # the stamps enclose the annotation


def test_op_by_op_epoch_spans():
    cfg = Config(batch=4)
    lut = traster.build_sprite_lut(CPU)
    agent = ActiveInferenceAgent()
    agent.init(seeded_generator(CPU, 0))
    state = tloop.TrainState(agent, tloop.make_optimizers(cfg, agent),
                             tloop.PrecisionState.create(0.5, device=CPU),
                             tenv.reset(seeded_generator(CPU, 2), cfg.batch, CPU))
    epoch = tloop.make_epoch_fn(cfg, lut, rounds=2, graphed=False)
    profiling.reset()
    epoch(state, torch.Generator().manual_seed(3))
    (ep,) = by_name("train.epoch")
    (rb,) = by_name("train.readback")
    draws = by_name("train.draws")
    assert ep.parent is None and rb.parent == "train.epoch"
    assert [d.parent for d in draws] == ["train.epoch"] * 2
    assert ep.start_ns <= draws[0].start_ns and rb.end_ns <= ep.end_ns
    # Draws handed in are the caller's: no train.draws.
    profiling.reset()
    g = torch.Generator().manual_seed(4)
    epoch(state, None, draws=[tloop.draw_round(agent, cfg, cfg.batch, g, CPU)
                              for _ in range(2)])
    assert set(profiling.totals()) == {"train.epoch", "train.readback"}


def test_op_by_op_sweep_spans():
    cfg = Config()
    lut = traster.build_sprite_lut(CPU)
    agent = ActiveInferenceAgent()
    agent.init(seeded_generator(CPU, 0))
    g = seeded_generator(CPU, 1)
    env = tenv.randomize(tenv.reset(g, 4, CPU), g)
    run = tsweep.make_sweep(agent, cfg, lut, method="habit", n_macro_steps=2, graphed=False)
    profiling.reset()
    run(torch.Generator().manual_seed(5), env)
    (sr,) = by_name("sweep.run")
    (rb,) = by_name("sweep.readback")
    assert sr.parent is None and rb.parent == "sweep.run"
    assert not by_name("efe.device")  # G is timed only inside a graph


# ------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_profiling.py` on one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_scan_records_its_warm_up_capture_and_replays(cuda_device):
    n = 5
    gr = graphs.Graphs()
    carry = torch.zeros(8, device=cuda_device)
    xs = [torch.full((8,), float(i), device=cuda_device) for i in range(n)]
    body = lambda c, x: (c + x, None)
    for call, (warm, capture, feed) in enumerate([(1, 1, n - 1), (0, 0, n)]):
        profiling.reset()
        out, _ = gr.scan(body, carry, xs, n)
        t = profiling.totals()
        assert (t.get("graphs.warm_up", (0,))[0], t.get("graphs.capture", (0,))[0],
                t["graphs.feed"].count, t["graphs.scan"].count) == (warm, capture, feed, 1)
        assert {s.parent for s in profiling.spans() if s.name != "graphs.scan"} == {
            "graphs.scan"}
        assert torch.equal(out, sum(xs))


@pytest.mark.cuda
@pytest.mark.parametrize("activities", [
    [ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA]],
    ids=["cpu+cuda", "cuda-only"])
def test_a_synced_kernel_lies_inside_its_span_on_the_trace_clock(cuda_device, activities):
    a = torch.randn(4096, 4096, device=cuda_device)
    (a @ a).sum().item()  # cuBLAS's set-up, outside the trace
    with profile(activities=activities) as prof:
        with profiling.span("port.kernel"):
            b = a @ a
            torch.cuda.synchronize()
    (s,) = by_name("port.kernel")
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    lo, hi = max(kernels, key=lambda k: k[1] - k[0])  # the matmul
    assert hi - lo > 100_000
    assert s.start_ns <= lo and hi <= s.end_ns, (s.start_ns - lo, hi - s.end_ns)
    del b


@pytest.mark.cuda
def test_graphed_ai_sweep_keeps_one_device_time_of_g_per_chunk(cuda_device):
    cfg = Config()
    lut = traster.build_sprite_lut(cuda_device)
    agent = ActiveInferenceAgent().to(cuda_device)
    agent.init(seeded_generator(cuda_device, 0))
    g = seeded_generator(cuda_device, 1)
    env = tenv.randomize(tenv.reset(g, 64, cuda_device), g)
    for method, chunks in (("ai", 3), ("habit", 0)):
        run = tsweep.make_sweep(agent, cfg, lut, method=method, n_macro_steps=4,
                                zero_score=False)
        profiling.reset()
        e = env
        for k in range(3):
            e = run(seeded_generator(cuda_device, 10 + k), e)["env"]
        samples = by_name("efe.device")
        assert len(samples) == chunks, method
        assert all(0 < s.end_ns - s.start_ns < 1e9 for s in samples)
        t = profiling.totals()
        assert t["graphs.feed"].count == 3 + 4 + 4 and t["sweep.draws"].count == 3 * 4
