"""The sweep's share of the card's dense TF32 peak: the FLOPs the window's
macro steps need at their shapes (``yardstick/flops.py`` ``macro_step``)
over the window's wall time. Most of them are convolutions, which cuDNN
runs in TF32 under PyTorch's defaults."""

from portbench.yardstick import peaks


def read(rec):
    return peaks.tf32_share(rec)
