"""The readers of the port's spans (``metrics/program_idle_pct.*``,
``capture_s``, ``load_s``, ``efe_device_ms.sweep``) on synthetic records
and a synthetic span registry."""

import importlib.util

import pytest

from deep_active_inference_mc_torch.utils.profiling import Span
from portbench import run
from portbench.tracing import Records

T = 1_700_000_000  # a stretch's start on the trace's clock (s)
NS = 10 ** 9


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  run.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(name, start_s, end_s, self_s=None, parent=None, thread=1):
    """A span between T + start_s and T + end_s."""
    lo, hi = int((T + start_s) * NS), int((T + end_s) * NS)
    self_ns = hi - lo if self_s is None else int(self_s * NS)
    return Span(name, parent, lo, hi, self_ns, thread)


# The stretch [T + 10, T + 11]: the card busy but for [10.4, 10.6].
TRACED = Records({}, {}, [("gemm", T + 10.0, T + 10.4), ("copy", T + 10.6, T + 11.0)],
                 (T + 10.0, T + 11.0))
EMPTY = Records({}, {}, [], None)


@pytest.mark.parametrize("name", ["program_idle_pct.sweep", "program_idle_pct.train"])
def test_program_idle_is_the_idle_time_inside_port_spans(name):
    read = reader(name)
    half = [span("train.epoch", 10.5, 10.8)]  # over the gap's second half
    assert read(TRACED, half) == pytest.approx(10.0)
    # Nested spans count once, a device span (no thread) and spans outside
    # the stretch not at all.
    nested = half + [span("graphs.scan", 10.55, 10.7, parent="train.epoch"),
                     span("efe.device", 10.0, 10.5, thread=None), span("sweep.run", 1.0, 9.0)]
    assert read(TRACED, nested) == pytest.approx(10.0)
    # A span over the whole gap: the whole idle share, as device_idle_pct.
    whole = [span("sweep.run", 9.0, 12.0)]
    assert read(TRACED, whole) == pytest.approx(20.0)
    assert run.read_metric("device_idle_pct.sweep", TRACED) == pytest.approx(20.0)
    # The host in the port only while the card was busy: nothing.
    assert read(TRACED, [span("sweep.readback", 10.0, 10.4)]) == pytest.approx(0.0)


def test_capture_s_is_self_time_before_the_stretch():
    spans = [
        span("graphs.warm_up", 1.0, 3.0, self_s=1.5),  # K1's 0.5 s load inside it
        span("k1.load", 1.2, 1.7, parent="graphs.warm_up"),
        span("graphs.capture", 3.0, 3.25),
        span("graphs.feed", 3.3, 3.31),
        span("graphs.capture", 9.0, 9.5),  # a re-capture in the window's first part
        span("graphs.capture", 10.5, 10.7),  # inside the stretch
        span("graphs.warm_up", 12.0, 13.0),  # after it (the efe_ms calls)
    ]
    assert reader("capture_s")(TRACED, spans) == pytest.approx(1.5 + 0.25 + 0.5)
    assert reader("capture_s")(TRACED, [span("graphs.feed", 1.0, 2.0)]) is None


def test_load_s_counts_nested_loads_once():
    spans = [
        span("checkpoint.load", 0.0, 2.0),
        span("raster.lut", 1.5, 2.5),  # overlapping the weights' load
        span("graphs.warm_up", 3.0, 5.0),
        span("k1.load", 3.5, 4.0, parent="graphs.warm_up"),
        span("raster.lut", 10.5, 11.0),  # in the stretch
    ]
    assert reader("load_s")(TRACED, spans) == pytest.approx(2.5 + 0.5)


def test_efe_device_ms_is_the_median_sample():
    samples = [span("efe.device", t, t + ms / 1e3, thread=None)
               for t, ms in ((2.0, 63.0), (5.0, 64.0), (9.0, 70.0))]
    assert reader("efe_device_ms.sweep")(TRACED, samples) == pytest.approx(64.0)


@pytest.mark.parametrize("name", ["program_idle_pct.sweep", "program_idle_pct.train",
                                  "capture_s", "load_s", "efe_device_ms.sweep"])
def test_readers_give_nothing_without_a_stretch_or_a_span(name):
    read = reader(name)
    every = [span(n, 1.0, 2.0) for n in ("graphs.warm_up", "graphs.capture", "k1.load",
                                         "sweep.run")] + [span("efe.device", 1.0, 1.06,
                                                               thread=None)]
    assert read(EMPTY, every) is None
    assert read(TRACED, []) is None
    assert run.read_metric(name, EMPTY) is None  # the running process's registry
