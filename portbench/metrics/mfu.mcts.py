"""The planner cell's share of the card's dense TF32 peak: the FLOPs the
window's plans needed (``yardstick/search.py`` ``plan_flops``, over the
port's planner counters: the envs' searched iterations and phase-A
short-circuits; the rows of decided envs that the batch computes and masks
are not counted) over the window's wall time. Most of them are the
decoder's, which runs in TF32."""

from portbench.yardstick import peaks


def read(rec):
    return peaks.tf32_share(rec)
