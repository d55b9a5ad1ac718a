"""Tracing: the port's spans, and a ``torch.profiler`` context for a block
of work.

Counterpart of ``deep_active_inference_mc_tpu/utils/profiling.py``, whose
``trace`` this module keeps: the trainer's ``--profile_dir`` wraps its
first epoch in ``trace``, which writes a chrome trace
(``epoch_trace.json``) of the host and, on a card, of the device.

``span(name)`` marks one host interval at a layer boundary of the port (an
epoch, a sweep chunk, a graph's capture or replay, a load). It is always
on and costs two clock reads and a few appends: each span is kept with its
name, the innermost open span of its thread as its parent, and its start
and end stamps on ``time.time_ns()``, the clock on which the torch
profiler stamps its events, so a span lines up with a device trace's
kernels. The last ``RING`` spans are kept in order (``spans()``), and per
name the count, total and self time (the duration less the part covered
by the span's children) of every span since the start or the last
``reset()`` (``totals()``). While a torch profiler runs, a span also
enters ``record_function(name)``, so it shows by name in the profiler's
trace. ``record_device(name, seconds)`` keeps a duration measured on the
device (CUDA events) as a span of no thread, and
``record_device_events(name, start, end)`` the time between two events
that a graph still to be replayed records, once ``settle()`` finds its end
event done (the callers settle where the host has synced anyway).

``count(name, n)`` adds to one of the port's named counters: a number on
the host, or a tensor that is summed into an accumulator on its own device
without a host sync; ``counters()`` reads them all (waiting for those on a
device). Besides them and the span counts, ``ops.cuda.LAUNCHES`` counts
the kernels' launches and ``Graphs.captures`` / ``replays`` a graph
cache's work. The epoch line reports throughput.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 65536  # the spans kept in order; the totals count every span


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the innermost open span of the thread when it began
    start_ns: int  # time.time_ns()
    end_ns: int
    self_ns: int  # the duration less the children's
    thread: Optional[int]  # threading.get_ident(); None for a device span


class Totals(NamedTuple):
    count: int
    total_ns: int
    self_ns: int


_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=RING)
_totals: Dict[str, List[int]] = {}
_local = threading.local()
_counts: Dict[str, Union[int, float]] = {}  # host counters
_device_counts: Dict[Tuple[str, torch.device], torch.Tensor] = {}  # accumulators
_pending: Dict[str, tuple] = {}  # device spans whose events may still run


def _profiler_running() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _keep(s: Span) -> None:
    with _lock:
        _ring.append(s)
        t = _totals.get(s.name)
        if t is None:
            _totals[s.name] = [1, s.end_ns - s.start_ns, s.self_ns]
        else:
            t[0] += 1
            t[1] += s.end_ns - s.start_ns
            t[2] += s.self_ns


class span:
    """``with span(name):`` keeps the enclosed block as a span (the
    module's docstring)."""

    __slots__ = ("name", "_parent", "_child_ns", "_annotation", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1] if stack else None
        self._child_ns = 0
        stack.append(self)
        # The stamps enclose the annotation (entered after the start,
        # left before the end), so its cost lies inside the span.
        self._t0 = time.time_ns()
        self._annotation = None
        if _profiler_running():
            self._annotation = _autograd_profiler.record_function(self.name)
            self._annotation.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        t1 = time.time_ns()
        _local.stack.pop()
        dur = t1 - self._t0
        parent = self._parent
        if parent is not None:
            parent._child_ns += dur
        _keep(Span(self.name, parent and parent.name, self._t0, t1, dur - self._child_ns,
                   threading.get_ident()))


def spanned(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def record_device(name: str, seconds: float) -> None:
    """Keep a duration measured on the device as a span of no thread and no
    parent, ending now."""
    end = time.time_ns()
    ns = int(round(seconds * 1e9))
    _keep(Span(name, None, end - ns, end, ns, None))


def record_device_events(name: str, start: "torch.cuda.Event",
                         end: "torch.cuda.Event") -> None:
    """Keep the time from ``start`` to ``end`` as a device span ``name``
    once ``settle()`` finds ``end`` done. The events may be recorded by a
    graph's replays: a pair kept again before it settles is read once."""
    with _lock:
        _pending[name] = (start, end)


def settle() -> None:
    """Keep, as ``record_device`` does, each pending device span whose end
    event has completed; one still running stays pending. Never waits."""
    with _lock:
        items = list(_pending.items())
    for name, pair in items:
        if not pair[1].query():
            continue
        with _lock:
            if _pending.get(name) is not pair:  # kept again meanwhile
                continue
            del _pending[name]
        try:
            seconds = pair[0].elapsed_time(pair[1]) / 1e3
        except RuntimeError:  # an event that no replay has recorded yet
            continue
        record_device(name, seconds)


def count(name: str, n: Union[int, float, torch.Tensor] = 1) -> None:
    """Add ``n`` to the counter ``name``. A tensor is summed on its device
    into that device's accumulator of the counter, with no host sync."""
    if not isinstance(n, torch.Tensor):
        with _lock:
            _counts[name] = _counts.get(name, 0) + n
        return
    with torch.inference_mode():
        x = n.detach().sum()
        x = x.to(torch.float64 if x.is_floating_point() else torch.int64)
        with _lock:
            acc = _device_counts.get((name, x.device))
            if acc is None:
                _device_counts[(name, x.device)] = x.clone()
            else:
                acc.add_(x)


def counters() -> Dict[str, Union[int, float]]:
    """Every counter since ``reset()``, its accumulators on devices read to
    the host (this waits for the work that adds to them)."""
    with _lock:
        out = dict(_counts)
        accs = list(_device_counts.items())
    for (name, _), acc in accs:
        out[name] = out.get(name, 0) + acc.item()
    return out


def spans() -> List[Span]:
    """The last ``RING`` spans, in the order they ended."""
    with _lock:
        return list(_ring)


def totals() -> Dict[str, Totals]:
    """Per name: every span's count, total and self time since ``reset()``."""
    with _lock:
        return {k: Totals(*v) for k, v in _totals.items()}


def reset() -> None:
    """Forget every span and counter kept so far (spans open now are kept at
    their end)."""
    with _lock:
        _ring.clear()
        _totals.clear()
        _counts.clear()
        _device_counts.clear()
        _pending.clear()


@contextlib.contextmanager
def trace(logdir: Optional[str], name: str = "epoch_trace.json") -> Iterator[None]:
    """Profile the enclosed block into ``logdir/name`` (a no-op when
    ``logdir`` is None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(logdir) / name))
