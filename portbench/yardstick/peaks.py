"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit). A run prints the card's power limit beside every share."""

TF32_FLOPS = 495e12  # tensor cores, dense
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def tf32_share(rec):
    """100 x the window's counted FLOPs over its wall time over the TF32
    peak, or None without a count."""
    f, t = rec.counters.get("flops"), rec.counters.get("window_s")
    if not f or not t:
        return None
    return 100.0 * f / t / TF32_FLOPS
