"""Seconds of CUDA graph capture before the traced stretch (set-up and
the window's first part): the self time of the port's ``graphs.warm_up``
and ``graphs.capture`` spans (``utils/graphs.py``; a nested span, K1's
``k1.load`` among them, excluded) that ended before the stretch began."""

from deep_active_inference_mc_torch.utils import profiling

CAPTURE = ("graphs.warm_up", "graphs.capture")


def read(rec, spans=None):
    """``spans``: the port's registry's (by default the running process's)."""
    spans = getattr(profiling, "spans", list)() if spans is None else spans
    if rec.stretch is None:
        return None
    start_ns = rec.stretch[0] * 1e9
    picked = [s.self_ns for s in spans if s.name in CAPTURE and s.end_ns <= start_ns]
    return 1e-9 * sum(picked) if picked else None
