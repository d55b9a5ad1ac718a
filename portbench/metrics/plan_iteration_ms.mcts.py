"""Milliseconds of one search iteration on the card: the median of the
run's ``mcts.device`` spans (``plan/mcts.py``: CUDA events captured around
the search step in the planner's graph, the last replay's time of each plan
kept once the sweep's read-back has synced)."""

import statistics

from deep_active_inference_mc_torch.utils import profiling


def read(rec, spans=None):
    """``spans``: the port's registry's (by default the running process's)."""
    spans = getattr(profiling, "spans", list)() if spans is None else spans
    ms = [1e-6 * (s.end_ns - s.start_ns) for s in spans if s.name == "mcts.device"]
    if rec.stretch is None or not ms:
        return None
    return statistics.median(ms)
