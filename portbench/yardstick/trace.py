"""Reduction of a device trace to busy time, idle gaps and time by kernel.

The busy share is ``chip_smoke.py``'s arithmetic (device time over the
host's wall time of the traced stretch), with the device time taken as the
union of the kernels' and copies' intervals, so that two overlapping
operations count once."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]  # (start, end) in seconds


def union_length(intervals: Sequence[Interval]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def top_by_name(named: Sequence[Tuple[str, float]], n: int = 10) -> List[List]:
    acc: Dict[str, float] = defaultdict(float)
    for name, sec in named:
        acc[name] += sec
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def idle_pct(rec):
    """100 x (1 - the union of the device's intervals over the traced
    stretch / the stretch), or None when nothing was traced."""
    if rec.stretch is None or not rec.kernels:
        return None
    lo, hi = rec.stretch
    busy = union_length([(max(s, lo), min(e, hi)) for _, s, e in rec.kernels
                         if e > lo and s < hi])
    return 100.0 * (1.0 - busy / (hi - lo))
