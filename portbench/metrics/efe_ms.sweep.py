"""Milliseconds of one graphed call of the G estimator at the ``ai``
sweep's shapes (``infer/efe.py`` ``calculate_G_4_repeated``, mean G, one
step, one sample), by CUDA events around 20 replays after the window."""


def read(rec):
    return rec.counters.get("efe_ms")
