"""Share of the untraced window in which no kernel, copy or set ran on
the device, in a training cell: the traced slice's device time (the union of
their intervals) a step, scaled to the window's steps (harness/trace.py)."""
from benchmark.harness.trace import untraced_idle_pct

UNIT = "%"
LAYER = "device"
MOVES = "train_rays_per_s"


def read(rec):
    return untraced_idle_pct(rec)
