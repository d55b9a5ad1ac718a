"""Seconds of loading before the traced stretch: the union of the port's
``checkpoint.load`` (the weights), ``raster.lut`` (the sprite table) and
``k1.load`` (K1's library, from its cache or built) spans that ended
before the stretch began, so a span nested in another of them counts
once."""

from deep_active_inference_mc_torch.utils import profiling
from portbench.yardstick import trace

LOADS = ("checkpoint.load", "raster.lut", "k1.load")


def read(rec, spans=None):
    """``spans``: the port's registry's (by default the running process's)."""
    spans = getattr(profiling, "spans", list)() if spans is None else spans
    if rec.stretch is None:
        return None
    start_ns = rec.stretch[0] * 1e9
    picked = [(s.start_ns, s.end_ns) for s in spans
              if s.name in LOADS and s.end_ns <= start_ns]
    return 1e-9 * trace.union_length(picked) if picked else None
