"""Spans, counters and the device trace of one run, recorded from the
benchmark's own files around its calls into the program.

A span is a named host interval around one call into a layer; a counter
counts work at the same boundary. With ``--trace 1`` the window's middle
stretch runs under ``torch.profiler`` (CUPTI): every span inside it is also
a ``record_function`` annotation, so the trace's idle gaps can be named by
what the host was doing. The per-layer readers (``metrics/``) read a
``Records``."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.yardstick import trace as tr

STRETCH = "portbench.stretch"
START = 0.3  # the traced stretch starts at this share of the window
NAME_CHARS = 160  # a kernel's name as the breakdown gives it (templates run to thousands)


@dataclasses.dataclass
class Records:
    """What a traced run leaves for the per-layer readers."""

    counters: Dict[str, float]
    spans: Dict[str, List[float]]  # name -> durations (s), whole window
    kernels: List[Tuple[str, float, float]]  # (name, start s, end s) in the stretch
    stretch: Optional[Tuple[float, float]]  # its bounds on the trace's clock (s)


class Tracer:
    """Spans and counters of one run; with ``trace``, the profiled stretch:
    it starts at the first unit boundary past ``START`` of the window and
    ends at the first one at least ``length`` seconds later."""

    def __init__(self, trace: bool, length: float):
        self.trace = trace
        self.length = length
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.counters: Counter = Counter()
        self._prof = None
        self._stretch_ctx = None
        self._t_started: Optional[float] = None
        self.stretch_host_s = 0.0
        self.kernels: List[Tuple[str, float, float]] = []
        self.stretch: Optional[Tuple[float, float]] = None
        self.host_spans: List[Tuple[str, float, float]] = []
        self.done = False
        self.paused_s = 0.0
        self.summary = ""

    @property
    def profiling(self) -> bool:
        return self._prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is not None:
            from torch.profiler import record_function
            ctx = record_function(name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] += n

    def boundary(self, elapsed: float, window: float) -> None:
        """Called by the window's loop between units of work. The time spent
        starting and stopping the profiler is ``paused_s``, which the
        per-layer readers take out of the window."""
        if not self.trace or self.done:
            return
        t0 = time.perf_counter()
        if self._prof is None and elapsed >= START * window:
            self._begin()
        elif self._prof is not None and t0 - self._t_started >= self.length:
            self.finish()
        else:
            return
        self.paused_s += time.perf_counter() - t0

    def _begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._stretch_ctx = record_function(STRETCH)
        self._stretch_ctx.__enter__()
        self._t_started = time.perf_counter()

    def finish(self) -> None:
        """Close the stretch (at the window's end if no boundary did)."""
        if self._prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self._stretch_ctx.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.stretch_host_s = time.perf_counter() - self._t_started
        for e in self._prof.profiler.kineto_results.events():
            lo, hi = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                self.kernels.append((e.name(), lo, hi))
            elif e.device_type() == DeviceType.CPU and e.is_user_annotation():
                if e.name() == STRETCH:
                    self.stretch = (lo, hi)
                else:
                    self.host_spans.append((e.name(), lo, hi))
        self._prof = None
        self.done = True

    def digest(self) -> dict:
        """busy_s and window_s of the stretch and the breakdown: the device
        operations that took most time, and the idle gaps by the innermost
        host span around each gap's start."""
        if self.stretch is None:
            raise RuntimeError("the traced run recorded no stretch of the window")
        lo, hi = self.stretch
        inside = [(max(s, lo), min(e, hi)) for _, s, e in self.kernels if e > lo and s < hi]
        busy = tr.union_length(inside)
        named = []
        for g0, g1 in tr.gaps(inside, lo, hi):
            around = [(s, e, n) for n, s, e in self.host_spans if s <= g0 < e]
            name = min(around, key=lambda x: x[1] - x[0])[2] if around else "host: no span"
            named.append((name, g1 - g0))
        ends = [e for _, _, e in self.kernels]
        self.summary = (f"trace: {len(inside)} device operations in a stretch of {hi - lo:.4f} s "
                        f"({self.stretch_host_s:.4f} s on the host clock); "
                        f"the last ends {hi - max(ends, default=lo):.4f} s before its end")
        return {
            "busy_s": busy, "window_s": hi - lo,
            "device_ops": tr.top_by_name([(n[:NAME_CHARS], e - s) for n, s, e in self.kernels
                                          if e > lo and s < hi]),
            "idle_gaps": tr.top_by_name(named),
        }
