"""Model FLOPs of the views of the traced run's measured window (a view's
forward, benchmark/harness/counts.py) over the window's length by the
host's clock and the H100's dense bf16 peak, in percent."""
from benchmark.harness.counts import PEAK_BF16

UNIT = "%"
LAYER = "renderer"
MOVES = "render_rays_per_s"


def read(rec):
    w = rec["window"]
    if w["seconds"] <= 0 or not w["rays"]:
        return None
    flops = rec["counts"].forward_flops(w["rays"])
    return 100.0 * flops / w["seconds"] / PEAK_BF16
