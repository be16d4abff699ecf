"""Model FLOPs of the steps of the traced run's measured window
(benchmark/harness/counts.py, from the configuration's widths and sample
counts) over the window's length by the host's clock and the H100's dense
bf16 peak, in percent.  The window runs without the profiler, whose cost
on the host would otherwise count against the step."""
from benchmark.harness.counts import PEAK_BF16

UNIT = "%"
LAYER = "step"
MOVES = "train_rays_per_s"


def read(rec):
    w = rec["window"]
    if w["seconds"] <= 0 or not w["steps"]:
        return None
    c = rec["counts"]
    n = rec["driver"].rays_per_step
    stage = rec["cell"].traffic["stage"]
    per_step = (c.mask_train_flops(n) if stage == "train_mask"
                else c.train_flops(n))
    return 100.0 * per_step * w["steps"] / w["seconds"] / PEAK_BF16
