"""K1's share of its roofline in a sweep: the bytes its renders need
(``yardstick/k1_bytes.py``, of the traced chunks' states) at the card's HBM
bandwidth, over K1's device time in the traced stretch. K1 is bound by
bytes: it computes next to nothing."""

from portbench.yardstick import k1_bytes, peaks


def read(rec):
    per_call = rec.counters.get("k1_bytes_per_call")
    if rec.stretch is None or not per_call:
        return None
    lo, hi = rec.stretch
    k1 = [e - s for name, s, e in rec.kernels if k1_bytes.KERNEL in name and s >= lo and e <= hi]
    if not k1:
        return None
    return 100.0 * len(k1) * per_call / peaks.HBM_BYTES_PER_S / sum(k1)
