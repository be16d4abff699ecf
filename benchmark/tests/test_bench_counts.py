"""The FLOP, byte and roofline counts against hand counts at small
shapes, and the trace reduction against a hand-made trace."""
import pytest

from benchmark.harness import counts
from benchmark.harness.trace import kernel_seconds, reduce_events

MLP = {"type": "mlp", "num_steps": [4, 2, 2], "prop_freq_degree": 1,
       "freq_degree": 1, "cp_rank": 2, "prop_hidden": 4, "prop_layers": 2,
       "hidden": 8, "num_layers": 2, "cp_res": 4,
       "view_mlp": {"hidden": 2, "layers": 2}}


def test_mlp_dims_and_macs():
    # trunk: in 3*(1+2)+2 = 11 -> 8 (skip at layer 1: 8 + 11) -> 16
    c = counts.MLPFieldCounts(MLP)
    assert c.trunk == [(11, 8), (19, 16)]
    assert counts.macs(c.trunk) == 11 * 8 + 19 * 16
    assert c.prop == [(9, 4), (4, 1)]
    assert c.view == [(31, 2), (2, 3)]


def test_mlp_forward_and_train_flops_by_hand():
    c = counts.MLPFieldCounts(MLP)
    prop, trunk, view = 9 * 4 + 4, 11 * 8 + 19 * 16, 31 * 2 + 2 * 3
    cp = 8 * 2
    assert c.forward_flops(3) == 2 * 3 * ((4 + 2) * prop
                                          + 2 * (trunk + cp) + view)
    # backward: weight grads of every layer, input grads of layers >= 1,
    # and of layer 0's CP columns (trunk) / none (proposals) / all (view)
    prop_t = 2 * prop + 4 * 1
    trunk_t = 2 * trunk + 19 * 16 + 2 * 8
    view_t = 2 * view + 2 * 3 + 31 * 2
    assert c.train_flops(3) == 2 * 3 * ((4 + 2) * prop_t
                                        + 2 * (trunk_t + 2 * cp) + view_t)


def test_roofline_bound_is_the_larger_limit():
    # 3.35 MB at 3.35 TB/s is 1 us; 989 MFLOP bf16 at 989 TFLOP/s is 1 us
    assert counts.bound_s([(3.35e6, 0, 0)]) == pytest.approx(1e-6)
    assert counts.bound_s([(0, 989e6 * 2, 0)]) == pytest.approx(2e-6)
    assert counts.bound_s([(3.35e6, 0, 67e6 * 3)]) == pytest.approx(3e-6)
    assert counts.bound_s([(1, 1, 1), (3.35e6, 0, 0)]) == pytest.approx(
        1e-6 + max(1 / 3.35e12, 1 / 989e12, 1 / 67e12))


def test_level_kernel_bytes_by_hand():
    c = counts.MLPFieldCounts(MLP)
    b, f, o = c.prop_fwd(n=5, T=4, Q=3, weights_out=True)
    # rays 6, edges 2 x 5, queries 3, next edges 3, weights 4 a ray (fp32)
    # and the bf16 weights
    assert b == 4 * 5 * (6 + 10 + 3 + 3) + 4 * 5 * 4 + 2 * (9 * 4 + 4)
    assert f == 2 * 5 * 4 * (9 * 4 + 4)
    assert o == 2 * 5 * 4 * 3 * 1
    assert len(c.level_train(5)) == 6 and len(c.level_render(5)) == 3


def test_hash_counts_by_hand():
    spec = {"num_levels": 2, "level_dim": 2, "base_resolution": 4,
            "log2_hashmap_size": 6, "desired_resolution": 8}
    f = {"type": "hashgrid", "num_steps": [2, 1, 1], "main_grid": spec,
         "prop_grids": [spec, spec], "grid_mlp": {"hidden": 3, "layers": 2},
         "prop_mlp": {"hidden": 2, "layers": 2},
         "view_mlp": {"hidden": 2, "layers": 2}}
    c = counts.HashFieldCounts(f)
    enc = 8 * 4
    grid = 4 * 3 + 3 * 16
    prop = 4 * 2 + 2 * 1
    view = 31 * 2 + 2 * 3
    assert c.forward_flops(1) == 2 * ((2 + 1) * (enc + prop)
                                      + (enc + grid) + view)


def test_trace_reduction_by_hand():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "train_one_step",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 50.0,
         "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 80.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 95.0, "dur": 20.0},
    ]
    r = reduce_events(ev)
    # busy: [10, 50] + [80, 90] + [95, 100] = 55 us of a 100 us window
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(55e-6)
    assert r["idle_gaps"][0] == ["train_one_step > aten::mm",
                                 pytest.approx(30e-6)]
    assert kernel_seconds(r, ["k1"]) == pytest.approx(35e-6)
    assert r["device_ops"] == [["k1", pytest.approx(35e-6)],
                               ["k2", pytest.approx(30e-6)]]
