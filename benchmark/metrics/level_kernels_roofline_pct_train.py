"""The level kernels' share of their roofline in a training step: the
least time of their work (two proposal levels forward and backward, the
final level forward and backward; benchmark/harness/counts.py) over the
device time of the kernels that do it, from the trace."""
from benchmark.harness.counts import MLPFieldCounts, bound_s
from benchmark.harness.trace import kernel_seconds

UNIT = "%"
LAYER = "kernels"
MOVES = "train_rays_per_s"
KERNELS = ("prop_level_sample_kernel", "prop_level_bwd_kernel",
           "reduce_partials", "final_input_kernel", "layer_gemm",
           "final_forward_composite", "final_composite_kernel",
           "final_cp_partial_kernel", "final_cp_reduce_kernel",
           "weight_grad_gemm")


def read(rec):
    t, traced, c = rec["trace"], rec["traced"], rec["counts"]
    if not t or not traced or not isinstance(c, MLPFieldCounts):
        return None
    dev_s = kernel_seconds(t, KERNELS)
    if dev_s <= 0:
        return None
    n = rec["driver"].rays_per_step
    return 100.0 * traced["steps"] * bound_s(c.level_train(n)) / dev_s
