"""The level kernels' share of their roofline in a render: the least time
of a view's proposal levels (with resampling) and final level, chunk by
chunk (benchmark/harness/counts.py), over the device time of the kernels
that do it, from the trace."""
from benchmark.harness.counts import MLPFieldCounts, bound_s
from benchmark.harness.trace import kernel_seconds

UNIT = "%"
LAYER = "kernels"
MOVES = "render_rays_per_s"
KERNELS = ("prop_level_sample_kernel", "final_input_kernel", "layer_gemm",
           "final_forward_composite")


def read(rec):
    t, traced, c = rec["trace"], rec["traced"], rec["counts"]
    if not t or not traced or not isinstance(c, MLPFieldCounts):
        return None
    dev_s = kernel_seconds(t, KERNELS)
    if dev_s <= 0:
        return None
    chunk = int(rec["cell"].traffic["flags"]["max_ray_batch"])
    per_view = rec["window"]["rays"] // max(rec["window"]["views"], 1)
    sizes = [min(chunk, per_view - i) for i in range(0, per_view, chunk)]
    view_s = sum(bound_s(c.level_render(n)) for n in sizes)
    return 100.0 * traced["views"] * view_s / dev_s
