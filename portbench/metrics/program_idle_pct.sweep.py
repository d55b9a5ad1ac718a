"""Share of the traced stretch in which no kernel or copy ran on the card
while the host was inside one of the port's spans (``utils/profiling.py``,
stamped on the trace's clock), in a sweep cell: 100 x (the device's idle
time less the part of it outside every span) / the stretch. At most
``device_idle_pct``; the rest of that is host time outside the port."""

from deep_active_inference_mc_torch.utils import profiling
from portbench.yardstick import trace


def read(rec, spans=None):
    """``spans``: the port's registry's (by default the running process's)."""
    spans = getattr(profiling, "spans", list)() if spans is None else spans
    host = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans if s.thread is not None]
    if rec.stretch is None or not rec.kernels or not host:
        return None
    lo, hi = rec.stretch
    clip = lambda xs: [(max(s, lo), min(e, hi)) for s, e in xs if e > lo and s < hi]
    busy = clip([(s, e) for _, s, e in rec.kernels])
    idle = sum(e - s for s, e in trace.gaps(busy, lo, hi))
    neither = sum(e - s for s, e in trace.gaps(busy + clip(host), lo, hi))
    return 100.0 * (idle - neither) / (hi - lo)
