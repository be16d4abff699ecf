"""The 95th percentile of the window's view latencies, from the call to
the numpy image returned (linear interpolation between order
statistics)."""
import numpy as np

UNIT = "ms"
LAYER = None
MOVES = None


def read(rec):
    lat = rec["window"].get("latency_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
