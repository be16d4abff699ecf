"""The port's VGG16-LPIPS (train/lpips.py) and its meter against the JAX
package on the CPU:
  - JAX's proxy weights (flax PRNGKey(0)) written by JAX's save_lpips_npz
    and read by the port's load_lpips_npz: the five taps and the distance
    against flax's on the same images, rel-max 1e-4; the port's own
    save_lpips_npz round-trips and JAX reads it;
  - convert_torch_lpips against JAX's on one torchvision / lpips layout
    state dict (bitwise);
  - the port's proxy: zero for identical images, symmetric, monotone in
    distortion (tests/test_lpips.py's checks);
  - the meter's modes (the proxy; an explicit .npz; $SANERF_LPIPS_WEIGHTS),
    and a weights path naming no file raising
    and report line; pixel_accuracy against JAX's.
Images of 35 x 33 and 48 x 40 pixels, from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.train import lpips as jl
from sanerf_hq_tpu.train.metrics import pixel_accuracy as j_pixel_accuracy
from sanerf_hq_tpu_torch.train import lpips as tl
from sanerf_hq_tpu_torch.train.metrics import LPIPSMeter, pixel_accuracy


def _img(seed, h=35, w=33):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def jax_proxy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "jax_proxy.npz")
    params = jl.random_lpips_params()
    jl.save_lpips_npz(path, params)
    return path, params


@pytest.fixture(scope="module")
def own_fn():
    params, mode = tl.load_lpips_params()
    assert mode == "torch-random-proxy"
    return tl.make_lpips_fn(params)


def test_taps_and_distance_match_flax(jax_proxy_npz):
    path, jparams = jax_proxy_npz
    params = tl.load_lpips_npz(path)
    x = np.stack([_img(0, 48, 40), _img(1, 48, 40)])
    y = np.clip(x + 0.1 * np.random.default_rng(2).normal(size=x.shape), 0,
                1).astype(np.float32)
    jtaps = jl.VGG16Taps().apply({"params": jparams["vgg"]}, jnp.asarray(x))
    taps = tl.vgg_from_params(params)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(taps) == len(jtaps) == 5
    for t, jt in zip(taps, jtaps):
        got = t.permute(0, 2, 3, 1).numpy()
        assert got.shape == jt.shape
        assert _rel_max(got, jt) <= 1e-4
    fn, jfn = tl.make_lpips_fn(params), jl.make_lpips_fn(jparams)
    for a, b in ((x, y), (x[0], y[0]), (x[1], x[1])):
        got, want = float(fn(a, b)), float(jfn(jnp.asarray(a),
                                               jnp.asarray(b)))
        assert got == pytest.approx(want, rel=1e-4, abs=1e-7)


def test_npz_round_trip_and_jax_reads_ours(tmp_path, jax_proxy_npz):
    params = tl.random_lpips_params(seed=3)
    path = str(tmp_path / "ours.npz")
    tl.save_lpips_npz(path, params)
    back = tl.load_lpips_npz(path)
    for name, leaf in params["vgg"].items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(back["vgg"][name][k], v)
    jparams = jl.load_lpips_npz(path)
    x, y = _img(4), _img(5)
    assert float(tl.make_lpips_fn(back)(x, y)) == pytest.approx(
        float(jl.make_lpips_fn(jparams)(jnp.asarray(x), jnp.asarray(y))),
        rel=1e-4)


def test_convert_torch_lpips_matches_jax():
    rng = np.random.default_rng(0)
    vgg_sd, in_ch, k = {}, 3, 0
    for ch, n_conv in tl._VGG_CFG:
        for _ in range(n_conv):
            idx = tl._TORCH_CONV_IDX[k]
            vgg_sd[f"features.{idx}.weight"] = rng.normal(
                0, 0.05, (ch, in_ch, 3, 3)).astype(np.float32)
            vgg_sd[f"features.{idx}.bias"] = rng.normal(
                0, 0.01, ch).astype(np.float32)
            in_ch, k = ch, k + 1
    lin_sd = {f"lin{t}.model.1.weight": rng.uniform(
        -0.2, 1, (1, c, 1, 1)).astype(np.float32)
        for t, c in enumerate(tl._TAP_CHANNELS)}
    ours = tl.convert_torch_lpips(
        {k: torch.from_numpy(v) for k, v in vgg_sd.items()}, lin_sd)
    want = jax.device_get(jl.convert_torch_lpips(vgg_sd, lin_sd))
    assert sorted(ours["vgg"]) == sorted(want["vgg"])
    for name in want["vgg"]:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(ours["vgg"][name][leaf],
                                          np.asarray(want["vgg"][name][leaf]))
    for a, b in zip(ours["lins"], want["lins"]):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.min() >= 0


def test_zero_symmetric_monotone(own_fn):
    x, y = _img(6), _img(7)
    assert float(own_fn(x, x)) == pytest.approx(0.0, abs=1e-6)
    d_xy, d_yx = float(own_fn(x, y)), float(own_fn(y, x))
    assert d_xy > 0 and d_xy == pytest.approx(d_yx, rel=1e-5)
    noise = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    d_small = float(own_fn(x, np.clip(x + 0.05 * noise, 0, 1)))
    d_large = float(own_fn(x, np.clip(x + 0.4 * noise, 0, 1)))
    assert 0 < d_small < d_large


def test_meter_modes(jax_proxy_npz, monkeypatch):
    path, jparams = jax_proxy_npz
    x, y = _img(9), _img(10)
    monkeypatch.delenv("SANERF_LPIPS_WEIGHTS", raising=False)
    proxy = LPIPSMeter(device="cpu")
    assert proxy.mode == "torch-random-proxy" and proxy.available
    proxy.update(x, y)
    proxy.update(x, x)
    assert proxy.report().startswith("LPIPS[torch-random-proxy] = ")
    assert proxy.measure() == pytest.approx(
        float(tl.make_lpips_fn(tl.random_lpips_params())(x, y)) / 2)
    want = float(jl.make_lpips_fn(jparams)(jnp.asarray(x), jnp.asarray(y)))
    explicit = LPIPSMeter(weights_path=path, device="cpu")
    monkeypatch.setenv("SANERF_LPIPS_WEIGHTS", path)
    from_env = LPIPSMeter(device="cpu")
    for m in (explicit, from_env):
        assert m.mode == "torch-vgg16-ckpt"
        m.update(x, y)
        assert m.measure() == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("via", ["argument", "environment"])
def test_missing_weights_raise(via, tmp_path, monkeypatch):
    """A weights path that names no file raises (JAX would take the proxy
    and only the mode's name would show it)."""
    missing = str(tmp_path / "no_such_weights.npz")
    if via == "argument":
        monkeypatch.delenv("SANERF_LPIPS_WEIGHTS", raising=False)
        kw = {"weights_path": missing}
    else:
        monkeypatch.setenv("SANERF_LPIPS_WEIGHTS", missing)
        kw = {}
    with pytest.raises(FileNotFoundError, match="no_such_weights"):
        tl.load_lpips_params(**kw)
    with pytest.raises(FileNotFoundError, match="no_such_weights"):
        LPIPSMeter(device="cpu", **kw)


def test_pixel_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    gt = rng.integers(-1, 3, (16, 16))
    pred = np.where(rng.random((16, 16)) < 0.7, gt, rng.integers(0, 3,
                                                                 (16, 16)))
    assert pixel_accuracy(pred, gt) == pytest.approx(
        j_pixel_accuracy(pred, gt), abs=0)
    assert pixel_accuracy(pred, np.full_like(gt, -1)) == \
        j_pixel_accuracy(pred, np.full_like(gt, -1)) == 0.0
