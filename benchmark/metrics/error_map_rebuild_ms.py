"""Host clock around each of the window's calls of
`stages.update_error_map` (which ends in a copy to the host), after the
queue is drained; the median."""
import statistics

UNIT = "ms"
LAYER = "loop"
MOVES = "train_rays_per_s"


def read(rec):
    ms = rec["window"].get("rebuild_ms")
    return statistics.median(ms) if ms else None
