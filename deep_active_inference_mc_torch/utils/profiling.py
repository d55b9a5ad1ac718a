"""Tracing: a ``torch.profiler`` context for a block of work.

Counterpart of ``deep_active_inference_mc_tpu/utils/profiling.py``: the
trainer's ``--profile_dir`` wraps its first epoch in ``trace``, which writes
a chrome trace (``epoch_trace.json``) of the host and, on a card, of the
device. Throughput counters live in the epoch line.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional

import torch


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
