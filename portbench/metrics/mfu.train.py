"""The training round's share of the card's dense TF32 peak: the FLOPs the
window's rounds need at their shapes (``yardstick/flops.py``
``train_round``) over the window's wall time."""

from portbench.yardstick import peaks


def read(rec):
    return peaks.tf32_share(rec)
