"""Model FLOPs of the SAM encodes of the traced run's measured window (an
encode's products from the configuration's widths, stages/sam_cache.py
`SamCounts`) over the window's length by the host's clock and the H100's
dense bf16 peak, in percent (the peak `train_mfu` and `render_mfu` use,
so that an encoder on the tensor cores cannot read over 100%)."""
from benchmark.harness.counts import PEAK_BF16

UNIT = "%"
LAYER = "step"
MOVES = "view_ms.p95"


def read(rec):
    w, c = rec["window"], rec["counts"]
    if w["seconds"] <= 0 or not w.get("views") \
            or not hasattr(c, "encode_flops"):
        return None
    return 100.0 * w["views"] * c.encode_flops() / w["seconds"] / PEAK_BF16
