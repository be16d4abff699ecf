"""The stage-3 training pieces of the port against the JAX package, on the
CPU: the losses of the mask step (ray-pair RGB loss, label regularisation,
the CE, its accuracy and the error-map update) on fixed logits, the mask
sampler, the object masks' loading and resizes, the mean-IoU meter and
the camera helpers; and the frozen parameters of the stage hand-off.

Bars: 1e-5 relative on the losses and the error map (both sides fp32, the
same operations); exact equality on masks, indices and cameras.  The
ray-pair anchors are random on both sides, so the loss is compared with
every patch ray an anchor (ray_pair_rgb_num_sample = patch size^2), where
the mean does not depend on the draw.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.train.steps as jsteps
import sanerf_hq_tpu_torch.train.steps as tsteps
from sanerf_hq_tpu.config import Config as JaxConfig
from sanerf_hq_tpu.data import provider as jprov
from sanerf_hq_tpu.data.rays import coarse_inds_from_fine as j_coarse
from sanerf_hq_tpu.data.sampler import fixed_fovy_intrinsics as j_fovy
from sanerf_hq_tpu.train.metrics import MeanIoUMeter as JaxMeanIoU
from sanerf_hq_tpu.train.stages import downscale_intrinsics as j_downscale
from sanerf_hq_tpu.train.state import create_train_state
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data import provider as tprov
from sanerf_hq_tpu_torch.data.rays import coarse_inds_from_fine
from sanerf_hq_tpu_torch.data.sampler import (fixed_fovy_intrinsics,
                                              sample_mask_batch)
from sanerf_hq_tpu_torch.data.synthetic import make_synthetic_dataset
from sanerf_hq_tpu_torch.models import MLPField
from sanerf_hq_tpu_torch.train.metrics import MeanIoUMeter
from sanerf_hq_tpu_torch.train.stages import downscale_intrinsics
from sanerf_hq_tpu_torch.train.state import (TrainState,
                                             freeze_mask_from_loaded,
                                             partial_load)
from sanerf_hq_tpu_torch.train.trainer import backbone_all_frozen

NG, P, PS, V, S, C = 16, 2, 4, 3, 4, 3  # global rays, patches, size, ...
STAGE3 = dict(num_rays=NG, num_local_sample=P, local_sample_patch_size=PS,
              n_inst=C, error_map_size=S, ray_pair_rgb_loss_weight=1.0,
              ray_pair_rgb_threshold=0.3, ray_pair_rgb_num_sample=PS * PS,
              ray_pair_rgb_iter=3, label_regularization_weight=0.5)


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


@pytest.fixture()
def batch():
    """A fixed render result and batch: logits, image, depth for NG + P*PS^2
    rays, labels with unlabelled (-1) rays, and distinct error-map cells."""
    rng = np.random.default_rng(0)
    n = NG + P * PS * PS
    gt = rng.integers(0, C, n)
    gt[rng.choice(NG, 4, replace=False)] = -1
    cells = rng.choice(V * S * S, NG, replace=False)
    return {
        "logits": rng.normal(size=(n, C)).astype(np.float32) * 2,
        "image": rng.uniform(size=(n, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 3.0, n).astype(np.float32),
        "gt_masks": gt, "img_inds": cells // (S * S),
        "inds_coarse": cells % (S * S),
        "local_error": rng.uniform(0.0, 0.4, P * PS * PS).astype(np.float32),
        "error_map": rng.uniform(0.1, 1.0, (V, S * S)).astype(np.float32),
    }


@pytest.mark.parametrize("pred_logistics", [False, True])
def test_ray_pair_rgb_loss_all_anchors_matches_jax(batch, pred_logistics):
    rgb = batch["image"][NG:].reshape(P, PS * PS, 3)
    probs = jax.nn.softmax(jnp.asarray(batch["logits"][NG:]), -1)
    inc = batch["local_error"].reshape(P, PS * PS)
    inc[1] = 0.5  # no coherent ray in patch 1: every ray is a candidate
    want = jsteps.ray_pair_rgb_loss(
        jax.random.PRNGKey(0), jnp.asarray(rgb),
        probs.reshape(P, PS * PS, C), jnp.asarray(inc),
        JaxConfig(**STAGE3), use_pred_logistics=pred_logistics)
    got = tsteps.ray_pair_rgb_loss(
        torch.Generator().manual_seed(0), torch.from_numpy(rgb),
        torch.tensor(np.asarray(probs)).reshape(P, PS * PS, C),
        torch.from_numpy(inc), Config(**STAGE3),
        use_pred_logistics=pred_logistics)
    _close(got.item(), float(want))


def test_label_regularization_matches_jax(batch):
    d, m = batch["depth"][NG:], batch["logits"][NG:]
    want = jsteps.label_regularization(jnp.asarray(d), jnp.asarray(m), PS, C)
    got = tsteps.label_regularization(torch.from_numpy(d),
                                      torch.from_numpy(m), PS, C)
    _close(got.item(), float(want))


def test_mask_step_losses_and_error_map_match_jax(batch, monkeypatch):
    """One mask step on fixed render outputs (the JAX step's render is
    replaced by constants; the port's losses are `mask_losses` of the same
    outputs): ce, label_reg, ray_pair, loss, acc and the updated error map,
    with the ray-pair gate on (step 5 > 3)."""
    out = {k: batch[k] for k in ("image", "depth")}
    monkeypatch.setattr(jsteps, "_render_apply", lambda *a, **k: {
        "instance_mask_logits": a[1]["params"]["logits"],
        **{k: jnp.asarray(v) for k, v in out.items()}})
    jcfg = JaxConfig(**STAGE3)
    step = jsteps.make_mask_train_step(None, jcfg)
    state = create_train_state(
        {"params": {"logits": jnp.asarray(batch["logits"])}}, 1e-2, 100)
    jb = {k: jnp.asarray(batch[k]) for k in ("gt_masks", "img_inds",
                                             "inds_coarse", "local_error")}
    jb.update(rays_o=jnp.zeros((len(batch["gt_masks"]), 3)),
              rays_d=jnp.ones((len(batch["gt_masks"]), 3)), step=5)
    _, jm, j_map = step(state, jb, jax.random.PRNGKey(1),
                        jnp.asarray(batch["error_map"]))

    logits = torch.from_numpy(batch["logits"]).requires_grad_()
    render = {"instance_mask_logits": logits,
              **{k: torch.from_numpy(v) for k, v in out.items()}}
    cfg = Config(**STAGE3)
    tb = {k: torch.from_numpy(np.asarray(batch[k]))
          for k in ("gt_masks", "img_inds", "inds_coarse", "local_error")}
    em = torch.from_numpy(batch["error_map"])
    em0 = em.clone()
    loss, tm, t_map = tsteps.mask_losses(render, tb, 5, em, cfg,
                                         torch.Generator().manual_seed(1))
    assert set(tm) == set(jm) == {"ce", "label_reg", "ray_pair", "loss",
                                  "acc"}
    for k in jm:
        _close(tm[k].item(), float(jm[k]))
    _close(t_map.numpy(), np.asarray(j_map))
    assert not torch.equal(t_map, em0)
    assert torch.equal(em, em0)  # a new map; the old one is untouched
    loss.backward()
    assert torch.isfinite(logits.grad).all() and logits.grad.abs().sum() > 0
    # at step 3 (not > ray_pair_rgb_iter) the ray-pair term is off
    off, tm3, _ = tsteps.mask_losses(render, tb, 3, em, cfg,
                                     torch.Generator().manual_seed(1))
    _close(off.item(), (tm3["ce"] + 0.5 * tm3["label_reg"]).item())


def _index_masks(V_, H, W):
    """Labels that name their own pixel: the sampler's gathers show which
    pixels it took."""
    return torch.arange(V_ * H * W).reshape(V_, H, W)


def test_sample_mask_batch_rays_patches_and_error():
    H = W = 16
    d = make_synthetic_dataset(2, H, W)
    poses = torch.from_numpy(d["poses"])
    intr = torch.from_numpy(d["intrinsics"])
    em = torch.full((2, S * S), 1e-3)
    em[0, 5] = 1.0  # view 0: nearly all mass on cell 5 (row 1, col 1)
    em[1] = torch.rand(S * S, generator=torch.Generator().manual_seed(0))
    n, cell = 4000, H // S
    b = sample_mask_batch(torch.Generator().manual_seed(3), _index_masks(
        2, H, W), poses, intr, em, n, 8, PS, H, W, S)
    assert b["rays_o"].shape == b["rays_d"].shape == (n + 8 * PS * PS, 3)
    assert b["gt_masks"].shape == (n + 8 * PS * PS,)
    assert b["local_error"].shape == (8 * PS * PS,)
    # global rays: the pixel lies in its drawn cell of its own view
    pix = b["gt_masks"][:n]
    view, r, c = pix // (H * W), (pix % (H * W)) // W, pix % W
    assert torch.equal(view, b["img_inds"])
    ic = b["inds_coarse"]
    assert ((r // cell == ic // S) & (c // cell == ic % S)).all()
    v0 = b["img_inds"] == 0
    assert (ic[v0] == 5).float().mean() > 0.95  # 1 / (1 + 15e-3) = 0.985
    assert 0.3 < v0.float().mean() < 0.7
    # the ray directions are those of the drawn pixel centres
    want_d = torch.einsum("nij,nj->ni", poses[view, :3, :3], torch.stack([
        (c + 0.5 - intr[2]) / intr[0], -(r + 0.5 - intr[3]) / intr[1],
        -torch.ones(n)], -1))
    assert torch.allclose(b["rays_d"][:n], want_d, atol=1e-5)
    # local patches: PS x PS row-major blocks of one view, inside the
    # frame, and local_error is the map at each ray's cell
    lp = b["gt_masks"][n:].reshape(8, PS, PS)
    lv, lr, lc = lp // (H * W), (lp % (H * W)) // W, lp % W
    assert (lv == lv[:, :1, :1]).all()
    assert torch.equal(lr - lr[:, :1, :1],
                       torch.arange(PS)[None, :, None].expand(8, PS, PS))
    assert torch.equal(lc - lc[:, :1, :1],
                       torch.arange(PS)[None, None, :].expand(8, PS, PS))
    assert (lr.max() <= H - 1) and (lc.max() <= W - 1)
    lcell = (lr * S // H) * S + lc * S // W
    assert torch.equal(b["local_error"], em[lv, lcell].reshape(-1))

    # without the error map: uniform pixels, cells from the pixels
    u = sample_mask_batch(torch.Generator().manual_seed(4), _index_masks(
        2, H, W), poses, intr, em, 500, 2, PS, H, W, S, use_error_map=False)
    pix = u["gt_masks"][:500] % (H * W)
    assert torch.equal(u["inds_coarse"], coarse_inds_from_fine(pix, H, W, S))


def test_coarse_inds_and_cameras_match_jax():
    inds = np.arange(0, 48 * 40, 7)
    np.testing.assert_array_equal(
        coarse_inds_from_fine(torch.from_numpy(inds), 48, 40, 16).numpy(),
        np.asarray(j_coarse(jnp.asarray(inds), 48, 40, 16)))
    np.testing.assert_array_equal(fixed_fovy_intrinsics(512, 60.0),
                                  np.asarray(j_fovy(512, 60.0)))
    intr = np.array([400.0, 380.0, 250.0, 190.0], np.float32)
    np.testing.assert_array_equal(downscale_intrinsics(intr, 375, 500, 128),
                                  j_downscale(intr, 375, 500, 128))


def test_resizes_match_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    for h, w, H, W in [(512, 512, 128, 128), (37, 53, 128, 91),
                       (50, 70, 25, 35), (64, 48, 32, 32)]:
        m = rng.integers(0, 3, (h, w)).astype(np.uint8)
        np.testing.assert_array_equal(
            tprov.resize_nearest(m, H, W),
            cv2.resize(m, (W, H), interpolation=cv2.INTER_NEAREST))
        f = rng.uniform(size=(h, w)).astype(np.float32)
        np.testing.assert_allclose(
            tprov.resize_linear(f, H, W),
            cv2.resize(f, (W, H), interpolation=cv2.INTER_LINEAR), atol=1e-5)


def _write_masks(root, names, H, W):
    rng = np.random.default_rng(6)
    valid = {}
    for i, name in enumerate(names):
        stem = os.path.splitext(name)[0]
        if i == 1:
            continue  # no mask file
        if i == 2:
            m = rng.uniform(size=(3, H, W)).astype(np.float32)  # class maps
        elif i == 3:
            m = np.zeros((1, H, W), np.uint8)
            m[0, 0, :3] = 1  # 3 foreground pixels: invalid
        else:
            m = (rng.uniform(size=(1, H // 2, W // 2)) > 0.5).astype(np.uint8)
        np.save(os.path.join(root, f"{stem}_obj_mask.npy"), m)
        valid[stem] = 0.2 if i == 4 else 0.9  # view 4: low score
    with open(os.path.join(root, "valid_dict.json"), "w") as f:
        json.dump(valid, f)


@pytest.mark.parametrize("n_views", [8, 40])
def test_load_object_masks_matches_jax(tmp_path, n_views):
    """Masks and valid views as the JAX loader gives them; past 25 valid
    views the ::3 subsample is topped up to 25 with seeded random views
    (unseeded in JAX, so only the subsample itself is compared)."""
    pytest.importorskip("cv2")  # the JAX loader resizes with OpenCV
    names = [f"f{i:03d}.png" for i in range(n_views)]
    H, W = 24, 32
    _write_masks(str(tmp_path), names, H, W)
    jm, jv = jprov.load_object_masks(str(tmp_path), names, H, W)
    tm, tv = tprov.load_object_masks(str(tmp_path), names, H, W, seed=3)
    np.testing.assert_array_equal(tm, jm)
    assert tm.dtype == np.int32 and tv.dtype == np.int64
    if n_views <= 25:
        np.testing.assert_array_equal(tv, jv)
        assert 1 not in tv and 3 not in tv and 4 not in tv
    else:
        valid = [i for i in range(n_views) if i not in (1, 3, 4)]
        sub = len(valid[::3])
        np.testing.assert_array_equal(tv[:sub], valid[::3])
        np.testing.assert_array_equal(jv[:sub], valid[::3])
        assert len(tv) == len(jv) == 25 and set(tv) <= set(valid)
        again = tprov.load_object_masks(str(tmp_path), names, H, W, seed=3)
        np.testing.assert_array_equal(again[1], tv)


def test_mean_iou_meter_matches_jax():
    rng = np.random.default_rng(7)
    jmeter, tmeter = JaxMeanIoU(), MeanIoUMeter()
    for _ in range(3):
        t = rng.integers(-1, 3, (20, 30))
        p = rng.integers(0, 3, (20, 30))
        jmeter.update(p, t)
        tmeter.update(p, t)
    tmeter.update(np.zeros((4, 4)), np.full((4, 4), -1))  # all unlabelled
    jmeter.update(np.zeros((4, 4)), np.full((4, 4), -1))
    assert tmeter.N == jmeter.N == 3
    assert tmeter.report() == jmeter.report()
    _close(tmeter.measure(), jmeter.measure())


def test_stage_hand_off_freezes_loaded_parameters():
    """The parameters an init checkpoint holds are loaded and frozen (no
    grad, not in Adam); the mask branch trains; backbone_all_frozen holds
    only when every backbone parameter is frozen."""
    kw = dict(hidden=32, num_layers=4, freq_degree=2, prop_hidden=16,
              cp_rank=4, cp_res=8)
    stage1 = MLPField(**kw, device="cpu", seed=1).state_dict()
    field = MLPField(**kw, with_mask=True, n_inst=2, feat_rank=4, feat_res=8,
                     device="cpu", seed=2)
    loaded = partial_load(field, stage1)
    frozen = freeze_mask_from_loaded(field, stage1)
    assert loaded == frozen == set(stage1)
    assert backbone_all_frozen(field, frozen)
    assert not backbone_all_frozen(field, frozen - {"view_mlp.layers.0.weight"})
    state = TrainState(field, 1e-2, 10, frozen=frozen)
    in_adam = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    for name, p in field.named_parameters():
        assert (name in frozen) == (not p.requires_grad), name
        assert (id(p) in in_adam) == p.requires_grad, name
        if name in stage1:
            assert torch.equal(p, stage1[name]), name
