"""Share of the untraced window in which no kernel, copy or set ran on
the device, in a SAM cache cell: the traced slice's device time (the
union of their intervals) a view, scaled to the window's views
(harness/trace.py)."""
from benchmark.harness.trace import untraced_idle_pct

UNIT = "%"
LAYER = "device"
MOVES = "view_ms.p95"


def read(rec):
    return untraced_idle_pct(rec)
