"""The port's hash-grid encoder (`ops/hashgrid.py`) against the JAX
package's on shared inputs: level metadata for every spec of the field,
the encoding with its table and input gradients (hashed and dense levels,
a dense level small enough for JAX's one-hot-matmul backward, points out of
bounds, smoothstep, align_corners, max_level, the tiled grid, packed), and
the TV and weight-decay losses with their gradients on JAX's points.

Bars: forward rel-max <= 1e-5 (fp32 both, sums of eight corner products in
another order); gradients rel-max <= 1e-4 (the table gradient is a
scatter-add in another order; the input gradient a sum of table
differences); level metadata exactly equal.
"""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.models import fields as jfields
from sanerf_hq_tpu.ops import hashgrid as jhg
from sanerf_hq_tpu_torch.models import fields as tfields
from sanerf_hq_tpu_torch.ops import hashgrid as thg

FWD, GRAD = 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _specs(mod):
    return {"main_1": mod.main_grid_spec(1.0), "main_2": mod.main_grid_spec(2.0),
            "feature": mod.feature_grid_spec(),
            "lightweight_mask": mod.lightweight_mask_grid_spec(),
            "prop_128": mod.prop_grid_spec(128),
            "prop_256": mod.prop_grid_spec(256)}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", list(_specs(tfields)))
def test_level_meta_matches_jax(name, packed):
    t = dataclasses.replace(_specs(tfields)[name], packed=packed)
    j = dataclasses.replace(_specs(jfields)[name], packed=packed)
    assert t.level_meta() == j.level_meta()
    assert t.total_params == j.total_params and t.row_dim == j.row_dim
    assert t.scale == j.scale and t.output_dim == j.output_dim


def test_published_grid_sizes():
    main = tfields.main_grid_spec(2.0)
    res = [m[0] for m in main.level_meta()]
    assert res[0] == 16 and res[-1] == 4097  # ceil rounding, not 4096
    assert main.total_params == 6_299_960
    assert tfields.prop_grid_spec(128).total_params == 383_264
    assert tfields.prop_grid_spec(256).total_params == 430_080
    feat = [m[0] for m in tfields.feature_grid_spec().level_meta()]
    assert feat[-3:] == [323, 407, 513]


def _spec(**kw):
    # 4 levels at resolutions 8 ... 64 with a 2^12 table: 8^3 and 16^3 are
    # dense (and <= 16384 rows, JAX's one-hot backward), 32^3 and 64^3 hash
    base = dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
                log2_hashmap_size=12, desired_resolution=64)
    base.update(kw)
    return base


CASES = {
    "linear": (_spec(), None),
    "smoothstep": (_spec(interpolation="smoothstep"), None),
    "align_corners": (_spec(align_corners=True), None),
    "max_level": (_spec(), 2),
    "tiled": (_spec(gridtype="tiled"), None),
    "packed": (_spec(packed=True), None),
    # 39^3 rows dense: past JAX's one-hot bound, its gather backward
    "big_dense": (_spec(base_resolution=24, desired_resolution=96,
                        log2_hashmap_size=17), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hash_encode_matches_jax(case):
    kw, max_level = CASES[case]
    jspec, tspec = jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)
    assert jspec.level_meta() == tspec.level_meta()
    rng = np.random.default_rng(0)
    table = rng.uniform(-1, 1, (jspec.total_params, jspec.row_dim)).astype(
        np.float32)
    bound = 2.0
    # about one point in five lies outside [-bound, bound] on some axis
    x = rng.uniform(-1.08 * bound, 1.08 * bound, (7, 37, 3)).astype(np.float32)
    cot = rng.normal(size=(7, 37, jspec.output_dim)).astype(np.float32)

    def jloss(tb, xx):
        out = jhg.hash_encode(tb, xx, jspec, bound=bound, max_level=max_level)
        return jnp.sum(out * cot), out

    (_, want), (g_tab, g_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(table), jnp.asarray(x))

    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    got = thg.hash_encode(tt, tx, tspec, bound=bound, max_level=max_level)
    (got * torch.from_numpy(cot)).sum().backward()

    assert got.shape == want.shape
    oob = (np.abs(x) > bound).any(-1)
    assert oob.any() and (~oob).any()
    assert np.all(got.detach().numpy()[oob] == 0)
    assert np.all(tx.grad.numpy()[oob] == 0)
    if max_level is not None:
        assert np.all(got.detach().numpy()[..., max_level * 2:] == 0)
    assert _rel(got.detach(), want) <= FWD
    assert _rel(tt.grad, g_tab) <= GRAD
    assert _rel(tx.grad, g_x) <= GRAD


def test_dense_level_takes_jax_onehot_backward():
    """The case above whose levels JAX differentiates through its one-hot
    matmul really does: its first two levels are dense and small."""
    meta = jhg.HashGridSpec(**CASES["linear"][0]).level_meta()
    small_dense = [not h and size <= jhg._ONEHOT_MAX_ROWS
                   for _, _, size, h in meta]
    assert small_dense == [True, True, False, False]


@pytest.mark.parametrize("kw", [_spec(), _spec(align_corners=True),
                                _spec(packed=True)], ids=["linear",
                                                          "align_corners",
                                                          "packed"])
def test_tv_and_wd_match_jax(kw):
    jspec, tspec = jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)
    rng = np.random.default_rng(1)
    table = rng.normal(size=(jspec.total_params, jspec.row_dim)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    n = 257
    # the points JAX's total_variation_loss draws from its key
    pts = np.array(jax.random.uniform(key, (n, 3), dtype=jnp.float32))
    tv_j, g_tv = jax.value_and_grad(
        lambda tb: jhg.total_variation_loss(tb, jspec, key, n_samples=n))(
        jnp.asarray(table))
    wd_j, g_wd = jax.value_and_grad(
        lambda tb: jhg.weight_decay_loss(tb, jspec))(jnp.asarray(table))

    tt = torch.from_numpy(table).requires_grad_()
    tv = thg.total_variation_loss_at(tt, tspec, torch.tensor(pts))
    (g_tv_t,) = torch.autograd.grad(tv, tt)
    wd = thg.weight_decay_loss(tt, tspec)
    (g_wd_t,) = torch.autograd.grad(wd, tt)
    assert float(tv.detach()) == pytest.approx(float(tv_j), rel=FWD)
    assert float(wd.detach()) == pytest.approx(float(wd_j), rel=FWD)
    assert _rel(g_tv_t, g_tv) <= GRAD
    assert _rel(g_wd_t, g_wd) <= GRAD


def test_tv_draws_points_from_the_generator():
    spec = thg.HashGridSpec(**_spec())
    table = thg.init_hash_table(torch.Generator().manual_seed(0), spec) * 1e4
    a, b, c = (thg.total_variation_loss(
        table, spec, torch.Generator().manual_seed(s), n_samples=64)
        for s in (5, 5, 6))
    assert float(a) == float(b) != float(c)
    pts = torch.rand((64, 3), generator=torch.Generator().manual_seed(5))
    assert float(a) == float(thg.total_variation_loss_at(table, spec, pts))


def test_init_hash_table_range_and_seed():
    spec = thg.HashGridSpec(**_spec(packed=True))
    t = thg.init_hash_table(torch.Generator().manual_seed(0), spec)
    assert t.shape == (spec.total_params, 16) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5
    again = thg.init_hash_table(torch.Generator().manual_seed(0), spec)
    assert torch.equal(t, again)


# ---------------------------------------------------------------------------
# K11's routing and level constants (the kernel itself runs only on the
# card: tests/test_torch_kernels_gpu.py)
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_the_twin_and_launches_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K11 launched for a CPU tensor")

    monkeypatch.setattr(thg, "_fwd", refuse)
    monkeypatch.setattr(thg, "_bwd", refuse)
    before = thg.hash_encode_cuda.launches
    kw, _ = CASES["linear"]
    spec = thg.HashGridSpec(**kw)
    assert thg.route("cpu", spec) == "twin"
    table = thg.init_hash_table(torch.Generator().manual_seed(0),
                                spec).requires_grad_()
    x = torch.rand((9, 3), generator=torch.Generator().manual_seed(1))
    out = thg.hash_encode(table, x * 2 - 1, spec)
    out.sum().backward()
    assert torch.equal(out, thg.hash_encode_unit(table, x, spec))
    assert table.grad is not None
    assert thg.hash_encode_cuda.launches == before == 0


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", list(_specs(tfields)))
def test_level_struct_matches_level_meta(name, packed):
    spec = dataclasses.replace(_specs(tfields)[name], packed=packed)
    lv = thg.level_struct(spec)
    meta = spec.level_meta()
    L = spec.num_levels
    strides = thg._levels(spec, L, torch.device("cpu")).strides  # [D, L]
    assert ctypes.sizeof(thg.HashLevels) == 8 * thg.MAX_LEVELS * 4
    for l in range(thg.MAX_LEVELS):
        got = (lv.res[l], lv.offset[l], lv.size[l], bool(lv.use_hash[l]))
        if l < L:
            assert got == meta[l]
            assert list(lv.stride[l]) == strides[:, l].tolist()
            fits = meta[l][2] * spec.row_dim * 4 <= thg.SHARED_BYTES
            assert lv.shared[l] == int(fits)
        else:
            assert got == (0, 0, 0, False) and list(lv.stride[l]) == [0] * 3
            assert lv.shared[l] == 0
    # the shared-memory path's level: the main grid's level 0 at C = 2
    if name.startswith("main") and not packed:
        assert [lv.shared[l] for l in range(L)] == [1] + [0] * (L - 1)


@pytest.mark.parametrize("change,reason", [
    (dict(input_dim=2), "input_dim 2"),
    (dict(level_dim=3), "level_dim 3"),
    (dict(num_levels=17), "17 levels"),
    ("float64", "dtypes"),
    ("points_need_grad", "gradient to the points"),
])
def test_cuda_case_k11_does_not_take_raises(change, reason):
    spec = thg.HashGridSpec(**_spec())
    dtypes, need = (torch.float32, torch.float32), False
    if change == "float64":
        dtypes = (torch.float32, torch.float64)
    elif change == "points_need_grad":
        need = True
    else:
        spec = dataclasses.replace(spec, **change)
    assert thg.route("cpu", spec, dtypes, need) == "twin"
    with pytest.raises(ValueError, match=reason):
        thg.route("cuda", spec, dtypes, need)
    # what K11 does take; any other device raises
    assert thg.route("cuda", thg.HashGridSpec(**_spec())) == "k11"
    with pytest.raises(ValueError, match="unsupported device"):
        thg.route("meta", thg.HashGridSpec(**_spec()))


@pytest.mark.parametrize("name", ["main_2", "feature", "lightweight_mask",
                                  "prop_128"])
def test_every_spec_of_the_field_is_k11s(name):
    for packed in (False, True):
        spec = dataclasses.replace(_specs(tfields)[name], packed=packed)
        assert thg.unsupported(spec) is None
        assert thg.route("cuda", spec) == "k11"


def test_launch_arguments_scale_as_aten_on_the_card():
    """x / (2 bound) by a CPU scalar is a product with the fp32 reciprocal
    on the card: the kernel gets that reciprocal."""
    spec = thg.HashGridSpec(**_spec(interpolation="smoothstep",
                                    align_corners=True, packed=True))
    args = thg._launch_args(spec, 3.0, 2)
    assert args[:5] == (4, 2, 2, 1, 3.0)
    assert args[5] == float(np.float32(1.0) / np.float32(6.0))
    assert args[6:8] == (1, 1)


def test_launch_reader_counts_over_the_span_slice(monkeypatch):
    """The benchmark's K11 launch metric: the counter over the span slice's
    steps, whichever reader installed the slice; silent without a card."""
    from types import SimpleNamespace

    from benchmark.harness import manifest
    root = __file__.rsplit("/tests/", 1)[0]
    mod = manifest.load_metric(f"{root}/benchmark",
                               "hash_kernel_launches_per_step.train")
    sync = manifest.load_metric(f"{root}/benchmark",
                                "host_syncs_per_step.train")

    def hooks(device):
        def window(seconds, steps=None):
            thg.hash_encode_cuda.launches += 6 * steps
            return {"steps": steps, "seconds": 0.01}

        cell = SimpleNamespace(traffic={"trace_steps": 3})
        driver = SimpleNamespace(cell=cell, window=window,
                                 device=torch.device(device))
        return SimpleNamespace(driver=driver, probes={}, after=[])

    monkeypatch.setattr(thg.hash_encode_cuda, "launches", 0)
    h = hooks("cpu")
    mod.install(h)
    for fn in h.after:
        fn()
    assert mod.read({"probes": h.probes}) is None  # a CPU run
    h = hooks("cuda")  # the tracer times nothing here: no card
    sync.install(h)  # the slice's callback first, as in BENCHMARK.json
    h.after.insert(0, lambda: h.driver.window(0, steps=5))  # another hook
    mod.install(h)
    mod.install(h)  # once a run
    assert len(h.after) == 2
    for fn in h.after:
        fn()
    assert mod.read({"probes": h.probes}) == 6.0
