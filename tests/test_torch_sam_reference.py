"""The port's SAM image encoder against the benchmark's plain reference
(benchmark/reference/sam.py: plain torch from segment-anything's
description, nothing of the port or of JAX), on seeded random weights at
a tiny size on the CPU, through `SamPredictor.set_image` as stage 2's
cache calls it; and the cache's per-view function.

Tolerance: both sides compute in fp32, the port through batched heads and
`nn` modules, the reference a head at a time through its own products, so
they differ by the order of fp32 sums alone: relative RMS gaps of about
5e-7 here.  TOL = 1e-5 leaves twenty times that, and is tight: the
reference with its operands at bf16, or with the relative-position terms
left out, misses it by two orders of magnitude or more.  The two resizes
(OpenCV's fixed-point INTER_LINEAR in the port, float bilinear rounded in
the reference) differ by at most one level of 255, so the encoders are
compared on the port's input, and the inputs under their own limit."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import sam as ref
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.provider import Scene
from sanerf_hq_tpu_torch.data.synthetic import make_synthetic_dataset
from sanerf_hq_tpu_torch.models import SANeRFField
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
from sanerf_hq_tpu_torch.sam import SamPredictor, build_sam
from sanerf_hq_tpu_torch.sam import build as sam_build
from sanerf_hq_tpu_torch.train import stages
from sanerf_hq_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
IMG = 112  # 16x16 patches: a 7x7 grid, padded to 8x8 by windows of 4
VIT = dict(embed_dim=32, depth=4, num_heads=2, window_size=4,
           global_attn_indexes=(1, 3))
CFG = dict(img_size=IMG, patch_size=16, mlp_ratio=4.0, out_chans=256, **VIT)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.fixture(scope="module")
def predictor():
    sam_build._CONFIGS["vit_ref"] = lambda: dict(VIT)
    try:
        sam = build_sam("vit_ref", img_size=IMG, seed=5, device="cpu")
    finally:
        del sam_build._CONFIGS["vit_ref"]
    return SamPredictor(sam, img_size=IMG)


def _params(pred):
    return dict(pred.sam.image_encoder.state_dict())


def _images():
    """A seeded noise image and a structured one, wider and taller than
    square."""
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:44, 0:26]
    ramp = np.stack([xx * 9, yy * 5, (xx + yy) % 7 * 30], -1)
    return [noise, ramp.clip(0, 255).astype(np.uint8)]


@pytest.mark.parametrize("k", [0, 1], ids=["noise", "structure"])
def test_encoder_matches_reference(predictor, k):
    img = _images()[k]
    feats = predictor.set_image(img)
    x, size = predictor.preprocess(img)
    x_ref, size_ref = ref.preprocess(torch.as_tensor(img), IMG)
    assert size == size_ref
    std = torch.tensor(ref.PIXEL_STD, dtype=torch.float64)
    mean = torch.tensor(ref.PIXEL_MEAN, dtype=torch.float64)
    levels = [torch.round(v.double() * std + mean) for v in (x, x_ref)]
    assert float((levels[0] - levels[1]).abs().max()) <= 1.0
    f_ref, interm_ref = ref.encode(_params(predictor), x, CFG, "fp32")
    assert _rel(feats, f_ref) < TOL
    assert len(interm_ref) == len(predictor.interm_features) == 2
    for a, b in zip(predictor.interm_features, interm_ref):
        assert _rel(a, b) < TOL


@pytest.mark.parametrize("variant", ["bf16", "no_rel_pos"])
def test_tolerance_catches_a_lower_precision_or_missing_rel_pos(predictor,
                                                                variant):
    img = _images()[1]
    feats = predictor.set_image(img)
    x, _ = predictor.preprocess(img)
    params = _params(predictor)
    if variant == "no_rel_pos":
        params = {n: torch.zeros_like(v) if "rel_pos" in n else v
                  for n, v in params.items()}
    f_ref, _ = ref.encode(params, x, CFG,
                          "bf16" if variant == "bf16" else "fp32")
    assert _rel(feats, f_ref) > 100 * TOL


def test_reference_imports_neither_the_port_nor_jax():
    path = os.path.join(ROOT, "benchmark", "reference", "sam.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "sanerf_hq_tpu", "sanerf_hq_tpu_torch")
                   for m in mods), mods
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.sam\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'sanerf_hq_tpu', "
            "'sanerf_hq_tpu_torch'))\n"
            "print(bad)\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_store_sam_features_writes_the_same_bytes(predictor, tmp_path):
    """The cache through the per-view function writes, view for view, the
    bytes of the render -> uint8 -> set_image -> .npy chain written out."""
    HW, n = 16, 3
    s = make_synthetic_dataset(n_views=n, H=HW, W=HW)
    scene = Scene(images=s["images"], poses=s["poses"],
                  intrinsics=np.tile(s["intrinsics"], (n, 1)), H=HW, W=HW,
                  img_names=np.array(["a.png", "b.png", "c.png"]))
    spec = dict(num_levels=3, level_dim=2, base_resolution=8,
                log2_hashmap_size=10, desired_resolution=32)
    cfg = Config(num_steps=(8, 4, 2), bound=4.0, min_near=0.05,
                 max_ray_batch=128, device="cpu")
    field = SANeRFField(grid_bound=cfg.grid_bound,
                        main_spec=HashGridSpec(**spec),
                        prop_spec_0=HashGridSpec(**spec),
                        prop_spec_1=HashGridSpec(**spec), device="cpu")
    tr = Trainer("t", cfg, field, str(tmp_path / "ws"), resume=False)
    stages.store_sam_features(tr, scene, predictor, str(tmp_path / "cache"))
    for i, stem in enumerate("abc"):
        out = tr.render_view(scene.poses[i], scene.intrinsics[i], HW, HW)
        rgb = (np.clip(out["image"].reshape(HW, HW, 3), 0, 1)
               * 255).astype(np.uint8)
        np.save(tmp_path / f"{stem}.npy",
                predictor.set_image(rgb)[0].cpu().numpy())
        with open(tmp_path / "cache" / f"{stem}.npy", "rb") as f:
            got = f.read()
        assert got == (tmp_path / f"{stem}.npy").read_bytes()
        feats = stages.encode_view(tr, predictor, scene.poses[i],
                                   scene.intrinsics[i], HW, HW)
        assert feats.shape == (7, 7, 256)
        assert np.load(tmp_path / f"{stem}.npy").tobytes() == feats.tobytes()
