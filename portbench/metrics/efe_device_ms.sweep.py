"""Milliseconds of the G estimator inside the sweep's macro-step graph:
the median of the run's ``efe.device`` spans (``train/sweep.py``: CUDA
events captured around the ``ai`` controller's G, the last replay's time
read after each chunk)."""

import statistics

from deep_active_inference_mc_torch.utils import profiling


def read(rec, spans=None):
    """``spans``: the port's registry's (by default the running process's)."""
    spans = getattr(profiling, "spans", list)() if spans is None else spans
    ms = [1e-6 * (s.end_ns - s.start_ns) for s in spans if s.name == "efe.device"]
    if rec.stretch is None or not ms:
        return None
    return statistics.median(ms)
