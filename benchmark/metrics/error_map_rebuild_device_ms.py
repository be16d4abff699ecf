"""Device time of one error-map rebuild's renders, from the program's own
spans: one more rebuild, after the slices, runs under `torch.profiler`
with the tracer off, where each `sanerf.rebuild.render` span (a view's
render up to its numpy probabilities) is a `record_function` range; the
union of the intervals of the kernels launched inside those ranges
(harness/spans.py `kernel_ms_in_ranges`).  The idle between the kernels
and the copies to the host are left out."""
import torch

from benchmark.harness import spans

UNIT = "ms"
LAYER = "loop"
MOVES = "train_rays_per_s"
KEY = "error_map_rebuild_device_ms"


def install(hooks):
    driver = hooks.driver
    if not hasattr(driver, "_rebuild") or not torch.cuda.is_available():
        return

    def run():
        hooks.probes[KEY] = spans.profiled_kernel_ms(
            lambda: driver._rebuild(False), "sanerf.rebuild.render",
            driver.workdir)

    hooks.after.append(run)


def read(rec):
    return rec["probes"].get(KEY)
