"""The port's stage-2 feature cache and point-prompt decode against the
JAX package's: the point projection and its gates on the cases of
tests/test_decode_points.py, the point file, the point overlay, and
store_sam_features and decode on one scene with shared field and SAM
weights (the tiny SAM of test_torch_sam.py).

Tolerances, fp32 on both sides: the projection, the point file and the
overlay are exactly equal.  The two trainers render the same weights
through different routes (JAX composable, the port's level-kernel twins;
here within 3e-6 on the image and 5e-5 on depth), and a render that
crosses a uint8 rounding edge moves the encoder's input by one level, so
each cached view's features (of scale 1 to 4) are held to max abs 5e-3;
with the JAX cache handed to both, the decodes give the same
valid_dict.json, the obj_mask.npy files differ in at most 1% of the
pixels, and the depth files are within 1e-3.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.config import Config as JaxConfig
from sanerf_hq_tpu.data.provider import load_scene as jax_load_scene
from sanerf_hq_tpu.data.synthetic import make_synthetic_dataset
from sanerf_hq_tpu.models import make_field as jax_make_field
from sanerf_hq_tpu.sam.predictor import SamPredictor as JaxPredictor
from sanerf_hq_tpu.train import stages as jax_stages
from sanerf_hq_tpu.train.trainer import Trainer as JaxTrainer
from sanerf_hq_tpu.utils import overlays as jax_overlays
from sanerf_hq_tpu.utils import points as jax_points
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.provider import load_scene
from sanerf_hq_tpu_torch.data.synthetic import write_llff_scene
from sanerf_hq_tpu_torch.models import make_field, params_from_jax
from sanerf_hq_tpu_torch.models.convert import flatten
from sanerf_hq_tpu_torch.sam import SamPredictor
from sanerf_hq_tpu_torch.train import stages
from sanerf_hq_tpu_torch.train.trainer import Trainer
from sanerf_hq_tpu_torch.utils import overlays, points
from test_decode_points import _analytic_depth
from test_torch_sam import IMG, _build_pair

HW = 32
SMALL = dict(num_steps=(16, 8, 8), cp_rank=8, cp_res=32)


def _gate_case(name):
    """The scenes of tests/test_decode_points.py: the analytic sphere's
    depth and prompts on its front surface, behind it, or behind the
    camera."""
    s = make_synthetic_dataset(n_views=4, H=64, W=64)
    pose, intr = s["poses"][0], s["intrinsics"]
    depth = _analytic_depth(pose, intr, 64, 64)
    eye = pose[:3, 3]
    front = (0.5 * eye / np.linalg.norm(eye)).astype(np.float32)
    one = dict(labels=np.array([1], np.int32),
               crucial_label=np.ones(1, np.int32), crucial_count=1,
               valid_threshold=1)
    if name == "front":
        kw = dict(points=front[None], **one)
    elif name == "occluded":
        kw = dict(points=(-front)[None], **one)
    elif name == "behind_camera":
        behind = (eye + eye / np.linalg.norm(eye)).astype(np.float32)
        kw = dict(points=behind[None], **one)
    else:  # the crucial point occluded, or the visible one crucial
        crucial = [0, 1] if name == "crucial_occluded" else [1, 0]
        kw = dict(points=np.stack([front, -front]),
                  labels=np.array([1, 1], np.int32),
                  crucial_label=np.array(crucial, np.int32),
                  crucial_count=1, valid_threshold=1)
    return pose, intr, depth, kw


@pytest.mark.parametrize("case", ["front", "occluded", "behind_camera",
                                  "crucial_occluded", "crucial_visible"])
@pytest.mark.parametrize("with_depth", [True, False])
def test_project_points_to_view_matches_jax(case, with_depth):
    pose, intr, depth, kw = _gate_case(case)
    d = depth if with_depth else None
    got_info, want_info = {}, {}
    got = points.project_points_to_view(
        points.PointPrompts(**kw), pose, intr, 64, 64, pred_depth=d,
        depth_tol=0.05, info=got_info)
    want = jax_points.project_points_to_view(
        jax_points.PointPrompts(**kw), pose, intr, 64, 64, pred_depth=d,
        depth_tol=0.05, info=want_info)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got_info.keys() == want_info.keys()
    for k in want_info:
        np.testing.assert_array_equal(got_info[k], want_info[k])
    if with_depth:  # the gate's verdicts of tests/test_decode_points.py
        assert got[3] == (case in ("front", "crucial_visible"))


@pytest.mark.parametrize("spec", [
    {"points": [[0.1, 0.2, 0.3], [0, 0, 1], [1, 1, 1]]},
    {"points": [[0.1, 0.2, 0.3], [0, 0, 1]], "negative_labels": [1],
     "crucial_point_index": [0], "valid_threshold": 1},
    {"points": [[0.0, 0.0, 0.0]] * 6, "valid_threshold": -1,
     "crucial_point_index": [2, 4]},
])
def test_load_point_file_matches_jax(spec, tmp_path):
    path = str(tmp_path / "points.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    got, want = points.load_point_file(path), jax_points.load_point_file(path)
    for field in ("points", "labels", "crucial_label"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.crucial_count, got.valid_threshold) == (
        want.crucial_count, want.valid_threshold)
    if "valid_threshold" not in spec or spec["valid_threshold"] == -1:
        assert got.valid_threshold == int(0.8 * len(spec["points"])) + 1


def test_overlay_point_matches_jax():
    img = np.random.default_rng(0).uniform(size=(20, 24, 3)).astype(
        np.float32)
    coords = np.array([[0, 0], [23, 19], [10, 7]])
    labels = np.array([1, 0, 1])
    np.testing.assert_array_equal(
        overlays.overlay_point(img, coords, inputs_point_labels=labels),
        jax_overlays.overlay_point(img, coords, inputs_point_labels=labels))
    np.testing.assert_array_equal(overlays.overlay_point(img, coords, 2),
                                  jax_overlays.overlay_point(img, coords, 2))


def _prompts_from_render(path, out, pose, intr, pixels):
    """Write a point file whose points sit where the rendered depth puts
    `pixels` of one view (through the projection's own flip), so they pass
    the depth gate in that view."""
    fx, fy, cx, cy = intr
    depth = out["depth"].reshape(HW, HW)
    pts = []
    for px, py in pixels:
        z = -float(depth[py, px])
        X = (HW - cx - (px + 0.5)) * z / fx
        Y = ((py + 0.5) - cy) * z / fy
        pts.append((pose @ np.array([X, Y, z, 1.0]))[:3].tolist())
    with open(path, "w") as f:
        json.dump({"points": pts, "crucial_point_index": [0],
                   "valid_threshold": 1}, f)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A JAX trainer and a port trainer over the same seeded MLP field, the
    tiny SAM with shared weights on both sides, a 32x32 llff scene and
    three of its views."""
    root = tmp_path_factory.mktemp("decode")
    scene_dir = str(root / "scene")
    write_llff_scene(scene_dir, n_views=17, H=HW, W=HW)
    jcfg = JaxConfig(path=scene_dir, data_type="llff", field_type="mlp",
                     workspace=str(root / "jax"), **SMALL)
    jt = JaxTrainer("ngp", jcfg, jax_make_field(
        "mlp", grid_bound=jcfg.grid_bound, cp_rank=8, cp_res=32),
        jcfg.workspace, use_checkpoint="none")
    params = params_from_jax(flatten(jax.device_get(jt.state.ema_params)))
    cfg = Config(path=scene_dir, data_type="llff", field_type="mlp",
                 workspace=str(root / "port"), device="cpu", **SMALL)
    model = make_field("mlp", device="cpu", grid_bound=cfg.grid_bound,
                       cp_rank=8, cp_res=32)
    pt = Trainer("ngp", cfg, model, cfg.workspace, resume=False)
    pt.state.load_weights(params)
    port_sam, jax_sam, _ = _build_pair(False)
    js, ps = jax_load_scene(scene_dir, "llff"), load_scene(scene_dir, "llff")
    for s in (js, ps):
        s.poses, s.img_names = s.poses[[0, 5, 16]], s.img_names[[0, 5, 16]]
        s.intrinsics = s.intrinsics[[0, 5, 16]]
        s.images = None
    return dict(root=root, jt=jt, pt=pt, js=js, ps=ps,
                jpred=JaxPredictor(jax_sam, img_size=IMG),
                ppred=SamPredictor(port_sam, img_size=IMG))


def test_store_sam_features_matches_jax(shared):
    jt, pt = shared["jt"], shared["pt"]
    jax_stages.store_sam_features(jt, shared["js"], shared["jpred"])
    stages.store_sam_features(pt, shared["ps"], shared["ppred"])
    jdir = os.path.join(jt.workspace, "sam_cache")
    pdir = os.path.join(pt.workspace, "sam_cache")
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "v00.npy", "v05.npy", "v16.npy"]
    for name in os.listdir(jdir):
        want, got = np.load(os.path.join(jdir, name)), np.load(
            os.path.join(pdir, name))
        assert got.shape == want.shape == (IMG // 16, IMG // 16, 256)
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 5e-3, name


def test_decode_matches_jax(shared):
    jt, pt, js, ps = (shared[k] for k in ("jt", "pt", "js", "ps"))
    jdir = os.path.join(jt.workspace, "sam_cache")
    if not os.path.isdir(jdir):
        jax_stages.store_sam_features(jt, js, shared["jpred"])
    # the same cache on both sides, so the decode alone is compared
    shutil.copytree(jdir, os.path.join(pt.workspace, "sam_cache"),
                    dirs_exist_ok=True)
    out0 = jt.render_view(js.poses[0], js.intrinsics[0], HW, HW)
    path = str(shared["root"] / "points.json")
    _prompts_from_render(path, {k: np.asarray(v) for k, v in out0.items()},
                         js.poses[0], js.intrinsics[0],
                         [(16, 16), (12, 20), (20, 11)])
    jout = jax_stages.decode(jt, js, shared["jpred"],
                             jax_points.load_point_file(path))
    pout = stages.decode(pt, ps, shared["ppred"],
                         points.load_point_file(path))
    with open(os.path.join(jout, "valid_dict.json")) as f:
        want_valid = json.load(f)
    with open(os.path.join(pout, "valid_dict.json")) as f:
        got_valid = json.load(f)
    assert got_valid == want_valid and got_valid["v00"] == 1
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    for stem in want_valid:
        want = np.load(os.path.join(jout, f"{stem}_obj_mask.npy"))
        got = np.load(os.path.join(pout, f"{stem}_obj_mask.npy"))
        assert got.shape == want.shape == (1, HW, HW)
        assert got.dtype == np.uint8
        assert np.mean(got != want) <= 1e-2, stem
        d_want = np.load(os.path.join(jout, f"{stem}_depth.npy"))
        d_got = np.load(os.path.join(pout, f"{stem}_depth.npy"))
        assert np.abs(d_got - d_want).max() <= 1e-3, stem
    m0 = np.load(os.path.join(pout, "v00_obj_mask.npy"))
    assert 0 < m0.sum() < m0.size  # a real mask, not all or nothing


def test_decode_distill_container_is_not_ported(shared):
    """decode knows the reference's two containers, cache and distill
    (tests/test_torch_distill.py decodes from the distilled features), and
    refuses any other name before it renders or writes anything."""
    out_dir = str(shared["root"] / "refused")
    with pytest.raises(ValueError, match="unknown feature_container"):
        stages.decode(shared["pt"], shared["ps"], shared["ppred"],
                      points.PointPrompts(np.zeros((1, 3), np.float32),
                                          np.ones(1, np.int32),
                                          np.zeros(1, np.int32), 0, 1),
                      out_dir=out_dir, feature_container="distil")
    assert not os.path.exists(out_dir)
