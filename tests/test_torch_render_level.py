"""Plain twins of the port's render-level kernels against the JAX Pallas
kernels run in interpret mode on the CPU (as tests/test_render_level_kernels
runs them): K5 `fused_prop_level_sample` and K3 `fused_final_level` with CP
features.  The CUDA kernels themselves are held to these twins on the card
by chip_smoke.py.

Tolerances are the JAX package's own for these kernels: 5e-3 abs on the
resampled s-bins (tests/test_render_level_kernels.py:198), rel-max 2e-2 on
the final level's outputs (:114).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.ops.render_level_pallas as rlp
from sanerf_hq_tpu_torch.ops import render_level as rl

N, T, Q = 256, 8, 9
GRID_BOUND, DB = 2.0, -1.5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(rlp, "INTERPRET", True)
    monkeypatch.setattr(rlp, "R_TILE", N)
    monkeypatch.setattr(rlp, "R_TILE_TRAIN", 2 * N)  # CP halves it to N


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture()
def rays():
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(N, 3)).astype(np.float32) * 2
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    bins = np.sort(rng.uniform(0.2, 4.0, (N, T + 1)), axis=1)
    s_bins = np.sort(rng.uniform(0.0, 1.0, (N, T + 1)), axis=1)
    u = np.linspace(0.5 / Q, 1.0 - 0.5 / Q, Q)[None] + rng.uniform(
        -0.4 / Q, 0.4 / Q, (N, Q))
    sh = rng.normal(size=(N, 16))
    return [np.asarray(a, np.float32) for a in (ro, rd, bins, s_bins, u, sh)]


def test_prop_level_sample_twin_matches_pallas(rays):
    ro, rd, bins, s_bins, u, _ = rays
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=s).astype(np.float32) * 0.3
          for s in [(39, 64), (64, 64), (64, 1)]]
    want = rlp.fused_prop_level_sample(
        *(jnp.asarray(a) for a in (ro, rd, bins, s_bins, u)),
        [jnp.asarray(w) for w in ws], 6, GRID_BOUND, opaque_last=True,
        density_bias=DB)
    got = rl.fused_prop_level_sample(
        *(_t(a) for a in (ro, rd, bins, s_bins, u)), [_t(w).T for w in ws], 6,
        GRID_BOUND, opaque_last=True, density_bias=DB)
    assert got.shape == (N, Q)
    assert float(got.diff(dim=-1).min()) >= -1e-5  # monotone edges
    assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-3


def test_final_level_twin_matches_pallas(rays):
    ro, rd, bins, _, _, sh = rays
    deg, rank, res, hid = 4, 4, 16, 32
    nin = 3 + 6 * deg + rank
    rng = np.random.default_rng(2)
    ws = [rng.normal(size=s).astype(np.float32) * 0.3
          for s in [(nin, hid), (hid, hid), (hid + nin, hid), (hid, 16)]]
    cps = [rng.normal(size=(res, rank)).astype(np.float32) * 0.3
           for _ in range(3)]
    jin = [jnp.asarray(a) for a in (ro, rd, bins, sh)]
    # fused_final_level is a thin delegate of final_level_train, which also
    # returns the per-sample weights the CUDA kernel writes
    want = rlp.final_level_train((deg, 2, GRID_BOUND, True, DB, rank, res),
                                 *jin, *(jnp.asarray(w) for w in ws),
                                 *(jnp.asarray(c) for c in cps))
    f3 = rlp.fused_final_level(*jin, [jnp.asarray(w) for w in ws], deg, 2,
                               GRID_BOUND, opaque_last=True, density_bias=DB,
                               cps=[jnp.asarray(c) for c in cps], cp_res=res)
    got = rl.fused_final_level(*(_t(a) for a in (ro, rd, bins, sh)),
                               [_t(w).T for w in ws], deg, 2, GRID_BOUND,
                               opaque_last=True, density_bias=DB,
                               cps=[_t(c) for c in cps], cp_res=res)
    names = ("f_image", "depth", "weights_sum", "weights")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) < 2e-2, name
    for name, a, b in zip(names, got, f3):
        assert _rel(a, b) < 2e-2, name


def test_twins_on_rays_that_miss_the_box():
    """near = far = 1e9 for a miss makes every interval zero: all weight on
    the opaque last sample, and nothing may turn into NaN."""
    from sanerf_hq_tpu_torch.ops.ray import spacing_fn, spacing_fn_inv

    n = 4
    ro = torch.full((n, 3), 500.0)
    rd = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    s = spacing_fn(torch.full((n, 1), 1e9))
    s_bins = torch.linspace(0, 1, T + 1).expand(n, T + 1).contiguous()
    real = spacing_fn_inv(s * (1 - s_bins) + s * s_bins)
    g = torch.Generator().manual_seed(0)
    pws = [torch.randn(64, 39, generator=g), torch.randn(64, 64, generator=g),
           torch.randn(1, 64, generator=g)]
    u = torch.linspace(0.5 / Q, 1 - 0.5 / Q, Q).expand(n, Q).contiguous()
    nxt = rl.fused_prop_level_sample(ro, rd, real, s_bins, u, pws, 6, 2.0)
    assert torch.isfinite(nxt).all()
    tws = [torch.randn(32, 63, generator=g), torch.randn(32, 32, generator=g),
           torch.randn(32, 95, generator=g), torch.randn(16, 32, generator=g)]
    f_img, depth, wsum, w = rl.fused_final_level(
        ro, rd, real, torch.randn(n, 16, generator=g), tws, 10, 2, 2.0)
    for x in (f_img, depth, wsum, w):
        assert torch.isfinite(x).all()
    assert torch.allclose(wsum, torch.ones(n))
    assert torch.allclose(w[:, -1], torch.ones(n))


def test_wrappers_dispatch_only_cpu_tensors_to_twins():
    """A CPU tensor runs the twin without counting a launch; any other
    device raises rather than falling back."""
    n = 4
    ro, rd = torch.zeros(n, 3), torch.ones(n, 3)
    bins = torch.linspace(0.2, 2.0, T + 1).expand(n, T + 1).contiguous()
    u = torch.full((n, Q), 0.5)
    pws = [torch.zeros(64, 39), torch.zeros(64, 64), torch.zeros(1, 64)]
    before = rl.fused_prop_level_sample.launches
    rl.fused_prop_level_sample(ro, rd, bins, bins, u, pws, 6, 2.0)
    assert rl.fused_prop_level_sample.launches == before
    meta = [x.to("meta") for x in (ro, rd, bins, bins, u)]
    with pytest.raises(ValueError, match="unsupported device"):
        rl.fused_prop_level_sample(*meta, pws, 6, 2.0)
    tws = [torch.zeros(32, 63), torch.zeros(32, 32), torch.zeros(32, 95),
           torch.zeros(16, 32)]
    with pytest.raises(ValueError, match="unsupported device"):
        rl.fused_final_level(*meta[:3], torch.zeros(n, 16, device="meta"),
                             tws, 10, 2, 2.0)


def _final_case(T, rank, hidden=32, deg=4, res=16, n=64, seed=3):
    """Rays, sh, trunk weights [out, in] and CP bases from one numpy seed."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(n, 3)) * 2
    rd = rng.normal(size=(n, 3))
    bins = np.sort(rng.uniform(0.2, 4.0, (n, T + 1)), axis=1)
    sh = rng.normal(size=(n, 16))
    nin = 3 + 6 * deg + rank
    ws = [rng.normal(size=s) * 0.3 for s in
          [(hidden, nin), (hidden, hidden), (hidden, hidden + nin),
           (16, hidden)]]
    cps = [rng.normal(size=(res, rank)) * 0.3 for _ in range(3)] if rank \
        else []
    rays = [_t(a) for a in (ro, rd, bins, sh)]
    return rays, [_t(w) for w in ws], [_t(c) for c in cps], deg, res


def _compose_parts(ro, rd, bins, sh, ws, deg, cps, res, need_geo):
    """K3's plain parts in the kernels' order: the inputs, A1, A2 beside
    h_in, A3, the fp32 last layer, the compositing."""
    h_in, _ = rl.final_level_inputs_ref(ro, rd, bins, deg, GRID_BOUND, cps,
                                        res)
    a1 = rl.layer_product_ref(h_in, ws[0])
    a2 = rl.layer_product_ref(a1, ws[1])
    a3 = rl.layer_product_ref(torch.cat([a2, h_in], dim=-1), ws[2])
    f = rl.layer_product_ref(a3, ws[3], relu=False)
    return rl.final_composite_ref(f, bins, sh, True, DB, need_geo)


@pytest.mark.parametrize("T,rank,need_geo", [(8, 4, True), (37, 0, False),
                                             (40, 4, True)])
def test_final_level_parts_compose_to_the_twin(T, rank, need_geo):
    """K3's plain parts (inputs, four layer products, compositing), composed
    as the kernels run them, give final_level_frozen_ref's outputs bit for
    bit, at sample counts that are and are not a multiple of 8 or 32."""
    (ro, rd, bins, sh), ws, cps, deg, res = _final_case(T, rank)
    got = _compose_parts(ro, rd, bins, sh, ws, deg, cps, res, need_geo)
    want = rl.final_level_frozen_ref(ro, rd, bins, sh, ws, deg, 2,
                                     GRID_BOUND, True, DB, cps, res,
                                     need_geo)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert torch.equal(a, b)
    h_in, xn = rl.final_level_inputs_ref(ro, rd, bins, deg, GRID_BOUND, cps,
                                         res)
    assert h_in.shape == (64 * T, 3 + 6 * deg + rank) and xn.shape == (
        64 * T, 3)
    assert torch.equal(h_in, h_in.to(torch.bfloat16).float())  # bf16 values


@pytest.mark.parametrize("rank", [0, 4])
def test_final_level_parts_match_pallas(rank):
    """K3's plain parts composed against the JAX kernel run in interpret
    mode on the same inputs, at the JAX package's rel-max 2e-2."""
    (ro, rd, bins, sh), ws, cps, deg, res = _final_case(8, rank, n=N)
    got = _compose_parts(ro, rd, bins, sh, ws, deg, cps, res, False)
    jin = [jnp.asarray(x.numpy()) for x in (ro, rd, bins, sh)]
    want = rlp.final_level_train(
        (deg, 2, GRID_BOUND, True, DB, rank, res), *jin,
        *(jnp.asarray(w.T.numpy()) for w in ws),
        *(jnp.asarray(c.numpy()) for c in cps))
    for name, a, b in zip(("f_image", "depth", "weights_sum", "weights"),
                          got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) < 2e-2, name


def test_final_level_part_wrappers_run_the_plain_parts_on_cpu():
    """On CPU tensors each K3 part wrapper runs its plain part without
    counting a launch; another device raises rather than falling back."""
    (ro, rd, bins, sh), ws, cps, deg, res = _final_case(8, 4)
    counters = (rl.final_level_inputs, rl.layer_product, rl.final_composite)
    before = [c.launches for c in counters]
    h_in, xn = rl.final_level_inputs(ro, rd, bins, deg, GRID_BOUND, cps, res,
                                     hidden=32)
    want = rl.final_level_inputs_ref(ro, rd, bins, deg, GRID_BOUND, cps, res)
    assert torch.equal(h_in, want[0]) and torch.equal(xn, want[1])
    a1 = rl.layer_product(h_in, ws[0])
    assert torch.equal(a1, rl.layer_product_ref(h_in, ws[0]))
    f = rl.layer_product(a1, ws[1][:16], relu=False)
    assert torch.equal(f, rl.layer_product_ref(a1, ws[1][:16], relu=False))
    out = rl.final_composite(f, bins, sh, True, DB, need_geo=True)
    ref = rl.final_composite_ref(f, bins, sh, True, DB, need_geo=True)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[4].shape == (64, 8, 15)
    assert [c.launches for c in counters] == before
    meta = f.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rl.final_composite(meta, bins.to("meta"), sh.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        rl.layer_product(meta, ws[0].to("meta"))
