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
