"""K6, the frozen-backbone final level: the port's plain twin
`final_level_frozen_ref` (what `fused_final_level_frozen` runs on CPU
tensors) against the JAX `fused_final_level_frozen` Pallas kernel in
interpret mode, with and without the per-sample trunk features.  The CUDA
kernel is held to the twin on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py).

Bar: rel-max 2e-2 on all five outputs, the JAX package's own bar for its
final-level kernels (tests/test_render_level_kernels.py:114).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.ops.render_level_pallas as rlp
from sanerf_hq_tpu_torch.ops import render_level as rl

N, T = 256, 8
GRID_BOUND, DB = 2.0, -1.5
DEG, RANK, RES, HID = 4, 4, 16, 32


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(rlp, "INTERPRET", True)
    monkeypatch.setattr(rlp, "R_TILE_TRAIN", 2 * N)  # CP halves it to N


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture()
def level():
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(N, 3)) * 2
    rd = rng.normal(size=(N, 3))
    bins = np.sort(rng.uniform(0.2, 4.0, (N, T + 1)), axis=1)
    sh = rng.normal(size=(N, 16))
    nin = 3 + 6 * DEG + RANK
    ws = [rng.normal(size=s) * 0.3
          for s in [(nin, HID), (HID, HID), (HID + nin, HID), (HID, 16)]]
    cps = [rng.normal(size=(RES, RANK)) * 0.3 for _ in range(3)]
    f32 = lambda xs: [np.asarray(x, np.float32) for x in xs]  # noqa: E731
    return f32((ro, rd, bins, sh)), f32(ws), f32(cps)


def _port_args(level):
    rays, ws, cps = level
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    return ([t(a) for a in rays], [t(w).T for w in ws], [t(c) for c in cps])


@pytest.mark.parametrize("need_geo", [True, False])
def test_frozen_final_level_twin_matches_pallas(level, need_geo):
    rays, ws, cps = level
    want = rlp.fused_final_level_frozen(
        *(jnp.asarray(a) for a in rays), [jnp.asarray(w) for w in ws], DEG,
        2, GRID_BOUND, opaque_last=True, density_bias=DB,
        cps=[jnp.asarray(c) for c in cps], cp_res=RES, need_geo=need_geo)
    prays, pws, pcps = _port_args(level)
    got = rl.fused_final_level_frozen(*prays, pws, DEG, 2, GRID_BOUND,
                                      opaque_last=True, density_bias=DB,
                                      cps=pcps, cp_res=RES,
                                      need_geo=need_geo)
    names = ("f_image", "depth", "weights_sum", "weights", "geo")
    for name, a, b in zip(names[:4], got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) < 2e-2, name
    if need_geo:
        assert got[4].shape == want[4].shape == (N, T, 15)
        assert _rel(got[4], want[4]) < 2e-2
    else:
        assert got[4] is None and want[4] is None


def test_frozen_twin_is_k3_twin_plus_geo(level):
    """K6's first four outputs are K3's (the kernel is K3 with one more
    store), and geo is the trunk's per-sample output after the density."""
    prays, pws, pcps = _port_args(level)
    args = (*prays, pws, DEG, 2, GRID_BOUND, True, DB, pcps, RES)
    k6 = rl.fused_final_level_frozen(*args, need_geo=True)
    k3 = rl.fused_final_level(*args)
    for a, b in zip(k6[:4], k3):
        assert torch.equal(a, b)
    # sum_s w_s * geo_s is the composited feature block of f_image
    comp = (k6[3][..., None] * k6[4]).sum(dim=1)
    assert torch.allclose(comp, k6[0][:, :15], atol=1e-5)


def test_frozen_wrapper_refuses_weights_that_need_grad(level):
    """K6 has no gradient: a weight that requires grad under grad mode
    raises (the JAX function stop-gradients its inputs); detached weights,
    or torch.no_grad, run."""
    prays, pws, pcps = _port_args(level)
    live = [w.clone().requires_grad_() for w in pws]
    with pytest.raises(ValueError, match="no gradient"):
        rl.fused_final_level_frozen(*prays, live, DEG, 2, GRID_BOUND,
                                    cps=pcps, cp_res=RES)
    with torch.no_grad():
        out = rl.fused_final_level_frozen(*prays, live, DEG, 2, GRID_BOUND,
                                          cps=pcps, cp_res=RES)
    assert out[4] is None and rl.fused_final_level_frozen.launches == 0
    meta = [x.to("meta") for x in prays]
    with pytest.raises(ValueError, match="unsupported device"):
        rl.fused_final_level_frozen(*meta, pws, DEG, 2, GRID_BOUND,
                                    cps=pcps, cp_res=RES, need_geo=True)
