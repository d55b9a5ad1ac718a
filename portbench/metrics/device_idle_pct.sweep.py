"""Share of the traced stretch in which no kernel or copy ran on the card,
in a sweep cell: 100 x (1 - union of device intervals / stretch)."""

from portbench.yardstick import trace


def read(rec):
    return trace.idle_pct(rec)
