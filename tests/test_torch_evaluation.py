"""The repository's offline mask benchmark (root evaluation.py) on the port's
stage-3 outputs, on the CPU.

The port trains the object field over a trainable backbone for 30 steps on
tests/test_torch_cli.py's 32 x 32 scene with sphere masks, then `--test
--with_mask` writes results/{stem}_mask.npy (probabilities [H, W, 2]) and
prints `[EVAL] MeanIoU`.  Then, each in a subprocess:
  - `evaluation.py simple` over results/*_mask.npy against the masks (the
    decode format's *_obj_mask.npy, as [H, W] labels): its per-image
    foreground IoU and accuracy equal the port's class-1 IoU and
    `pixel_accuracy`, and its run on the complemented labels gives the
    background IoU, so that the mean of the two over the views equals the
    port's MeanIoU (to the 6 digits it prints, and to its MeanIoUMeter on
    the same files exactly);
  - `evaluation.py benchmark --method ours` over a one-scene metadata set
    (the workspace at <img_root>/{scene}-{object}-nerf, ground truth as
    {img}_mask.png): the object's accumulated IoU and accuracy equal the
    port's on the same predictions.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data.png import write_png
from sanerf_hq_tpu_torch.data.synthetic import (write_llff_scene,
                                                write_sphere_masks)
from sanerf_hq_tpu_torch.train.metrics import MeanIoUMeter, pixel_accuracy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
STEMS = ("v00", "v16")  # the default val split of 17 views
S3 = ["--field_type", "mlp", "--data_type", "llff", "--num_steps", "16",
      "8", "8", "--cp_rank", "8", "--cp_res", "32", "--device", "cpu",
      "--with_mask", "--feat_rank", "8", "--feat_res", "16",
      "--online_resolution", str(HW), "--error_map_size", "8"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the stage-3 workspace, the masks' directory, the image root, the
    printed MeanIoU, as printed)."""
    tmp = tmp_path_factory.mktemp("eval")
    scene, masks = str(tmp / "scene"), str(tmp / "masks")
    write_llff_scene(scene, n_views=17, H=HW, W=HW)
    write_sphere_masks(masks, n_views=17, H=HW, W=HW)
    img_root = str(tmp / "runs")
    ws = os.path.join(img_root, "sphere-ball-nerf")
    cli.main([scene, "--workspace", ws, *S3, "--mask_root", masks,
              "--iters", "30", "--num_rays", "256", "--lr", "5e-2",
              "--local_sample_patch_size", "4", "--num_local_sample", "2"])
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([scene, "--workspace", ws, *S3, "--mask_root", masks,
                  "--test"])
    miou = re.search(r"\[EVAL\] MeanIoU = ([0-9.]+)",
                     buf.getvalue()).group(1)
    return ws, masks, img_root, miou


def _labels(masks, stem):
    return np.load(os.path.join(masks, f"{stem}_obj_mask.npy"))[0].astype(
        np.int64)


def _pred(ws, stem):
    return np.load(os.path.join(ws, "results", f"{stem}_mask.npy")).argmax(-1)


def _iou(pred, gt, cls):
    return (np.logical_and(pred == cls, gt == cls).sum()
            / np.logical_or(pred == cls, gt == cls).sum())


def _simple(pred_root, gt_root, out):
    r = subprocess.run([sys.executable, "evaluation.py", "simple",
                        "--pred_root", pred_root, "--gt_root", gt_root,
                        "--suffix", "_mask.npy", "--out", out], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        return json.load(f)


def test_simple_mode_on_port_outputs_gives_its_mean_iou(run, tmp_path):
    ws, masks, _, miou = run
    gt, inv_gt, inv_pred = (str(tmp_path / d) for d in ("gt", "inv_gt",
                                                         "inv_pred"))
    for d in (gt, inv_gt, inv_pred):
        os.makedirs(d)
    meter = MeanIoUMeter()
    for stem in STEMS:
        labels = _labels(masks, stem)
        probs = np.load(os.path.join(ws, "results", f"{stem}_mask.npy"))
        np.save(os.path.join(gt, f"{stem}.npy"), labels)
        np.save(os.path.join(inv_gt, f"{stem}.npy"), 1 - labels)
        np.save(os.path.join(inv_pred, f"{stem}_mask.npy"),
                probs[..., ::-1])
        meter.update(probs.argmax(-1), labels)
    fg = _simple(os.path.join(ws, "results"), gt, str(tmp_path / "fg.json"))
    bg = _simple(inv_pred, inv_gt, str(tmp_path / "bg.json"))
    assert fg["num_images"] == bg["num_images"] == len(STEMS)
    for stem in STEMS:
        pred, labels = _pred(ws, stem), _labels(masks, stem)
        assert fg["per_image"][stem]["iou"] == pytest.approx(
            _iou(pred, labels, 1), abs=1e-12)
        assert bg["per_image"][stem]["iou"] == pytest.approx(
            _iou(pred, labels, 0), abs=1e-12)
        assert fg["per_image"][stem]["acc"] == pytest.approx(
            pixel_accuracy(pred, labels), abs=1e-12)
    mean = np.mean([(fg["per_image"][s]["iou"] + bg["per_image"][s]["iou"])
                    / 2 for s in STEMS])
    assert mean == pytest.approx(meter.measure(), abs=1e-12)
    assert f"{mean:.6f}" == miou  # as the port prints it


def test_benchmark_mode_ours_on_port_outputs(run, tmp_path):
    ws, masks, img_root, _ = run
    gt_root = str(tmp_path / "gt")
    os.makedirs(os.path.join(gt_root, "sphere", "ball"))
    for stem in STEMS:
        m = (_labels(masks, stem) * 255).astype(np.uint8)
        write_png(os.path.join(gt_root, "sphere", "ball", f"{stem}_mask.png"),
                  np.repeat(m[..., None], 3, -1))
    files = {"meta": {"sphere": {"ball": {}}},
             "scene_list": {"llff": ["sphere"]},
             "eval_views": {"sphere": {"ball": list(STEMS)}}}
    for name, obj in files.items():
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(obj, f)
    out = str(tmp_path / "bench.json")
    r = subprocess.run(
        [sys.executable, "evaluation.py", "benchmark", "--method", "ours",
         "--img_root", img_root, "--mask_data_root", gt_root,
         "--meta", str(tmp_path / "meta.json"),
         "--scene_list", str(tmp_path / "scene_list.json"),
         "--eval_views", str(tmp_path / "eval_views.json"), "--out", out],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        obj = json.load(f)["llff"]["objects"]["sphere_ball"]
    preds = [_pred(ws, s) for s in STEMS]
    gts = [_labels(masks, s) for s in STEMS]
    inter = sum(np.logical_and(p == 1, g == 1).sum()
                for p, g in zip(preds, gts))
    union = sum(np.logical_or(p == 1, g == 1).sum()
                for p, g in zip(preds, gts))
    assert obj["iou"] == pytest.approx(inter / union, abs=1e-12)
    assert obj["acc"] == pytest.approx(
        np.mean([pixel_accuracy(p, g) for p, g in zip(preds, gts)]),
        abs=1e-12)
