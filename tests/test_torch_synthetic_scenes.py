"""The rich and clutter scenes of the port (`data/synthetic.py`), its scene
writer (`tools/make_synth_scene.py`) and `tools/colmap2nerf.py` against
the JAX package's, and `scripts/bench_rich_scene.sh`'s flag sets through
the port's CLI on the CPU.

Bars: images max abs <= 1e-6 (the same float32 arithmetic); object ids,
poses, intrinsics and split names equal; the writers' files equal (PNGs
after decoding, `.npy` arrays, parsed JSON; the COLMAP `.bin` files byte
for byte); the two colmap2nerf transforms.json equal.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sanerf_hq_tpu.data import synthetic as jax_syn
from sanerf_hq_tpu_torch.data import synthetic as syn
from sanerf_hq_tpu_torch.data.png import read_png
from sanerf_hq_tpu_torch.tools import colmap2nerf, make_synth_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _datasets(kind):
    if kind == "rich":
        kw = dict(n_views=4, H=30, W=40)
        return syn.make_rich_dataset(**kw), jax_syn.make_rich_dataset(**kw)
    kw = dict(n_views=4, H=30, W=40, n_extrap=2)
    return (syn.make_clutter_dataset(**kw),
            jax_syn.make_clutter_dataset(**kw))


@pytest.mark.parametrize("kind", ["rich", "clutter"])
def test_scene_datasets_match_jax(kind):
    got, want = _datasets(kind)
    assert sorted(got) == sorted(want)
    assert got["images"].dtype == want["images"].dtype == np.float32
    assert np.abs(got["images"] - want["images"]).max() <= 1e-6
    for k in ("obj_ids", "poses", "intrinsics"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("H", "W", "val_names", "n_inst"):
        assert got.get(k) == want.get(k), k


@pytest.mark.parametrize("kind", ["rich", "clutter"])
def test_scene_renders_match_jax_off_the_rig(kind):
    """One view from above and across the scene, off both camera rigs:
    every object's branch (the ground disk's edge, the box's faces, the
    cylinder) in one frame."""
    pose = syn.look_at_pose([1.7, 2.2, -1.9], center=(0.1, -0.3, 0.2))
    intr = np.array([40.0, 40.0, 24.0, 18.0], np.float32)
    fn = "render_rich_scene" if kind == "rich" else "render_clutter_scene"
    img, ids = getattr(syn, fn)(pose, intr, 36, 48)
    img_j, ids_j = getattr(jax_syn, fn)(pose, intr, 36, 48)
    assert img.shape == (36, 48, 3) and img.dtype == np.float32
    assert np.abs(img - img_j).max() <= 1e-6
    assert ids.dtype == ids_j.dtype
    np.testing.assert_array_equal(ids, ids_j)
    assert len(np.unique(ids)) >= (4 if kind == "rich" else 6)


def test_clutter_scene_labels_occlusion_and_texture():
    """tests/test_clutter_scene.py's properties, on the port's scene."""
    d = syn.make_clutter_dataset(n_views=8, H=60, W=80, n_extrap=2)
    assert d["images"].shape == (10, 60, 80, 3)
    assert d["n_inst"] == 8
    assert set(np.unique(d["obj_ids"])) == set(range(8))
    # the small sphere (object 5) tucked behind the box: visible, but far
    # smaller than its unoccluded siblings
    counts = [(d["obj_ids"] == k).sum() for k in range(8)]
    assert 0 < counts[5] < counts[3] and counts[5] < counts[4]
    # the extrapolated val views sit above every training camera
    assert d["poses"][8:, 1, 3].min() > d["poses"][:8, 1, 3].max()
    assert d["val_names"] == ["v008", "v009"]
    d = syn.make_clutter_dataset(n_views=2, H=120, W=160, n_extrap=0)
    assert np.abs(np.diff(d["images"][0], axis=1)).mean() > 0.02


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("fmt,kind", [("llff", "rich"), ("llff", "clutter"),
                                      ("colmap", "rich"),
                                      ("colmap", "clutter")])
def test_scene_writer_matches_jax_script(tmp_path, fmt, kind):
    """tools/make_synth_scene against scripts/make_synth_scene.py (run
    under JAX on the CPU) on the same flags: the same files, PNGs equal
    after decoding, .npy arrays and JSON equal, COLMAP's .bin files equal
    byte for byte."""
    args = ["--format", fmt, "--scene", kind, "--n_views", "4", "--H", "24",
            "--W", "32"]
    jax_root, root = str(tmp_path / "jax"), str(tmp_path / "port")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_synth_scene.py"),
                    jax_root, *args], check=True, cwd=REPO,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"),
                   capture_output=True, timeout=300)
    names = make_synth_scene.main([root, *args])
    files = _files(jax_root)
    assert _files(root) == files
    n = 8 if kind == "clutter" else 4
    assert names == [f"v{i:03d}.png" for i in range(n)]
    assert ("test_views.json" in files) == (kind == "clutter")
    assert ("transforms.json" in files) == (fmt == "llff")
    assert (os.path.join("sparse", "0", "points3D.bin") in files) == (
        fmt == "colmap")
    for f in files:
        a, b = os.path.join(root, f), os.path.join(jax_root, f)
        if f.endswith(".png"):
            img = read_png(a)
            assert img.shape == (24, 32, 3)
            np.testing.assert_array_equal(img, read_png(b), err_msg=f)
        elif f.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        elif f.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), f
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
    # the PNG holds the truncated uint8 of the rendered image
    d = (syn.make_rich_dataset if kind == "rich" else
         syn.make_clutter_dataset)(n_views=4, H=24, W=32)
    np.testing.assert_array_equal(
        read_png(os.path.join(root, "images", "v001.png")),
        (d["images"][1] * 255).astype(np.uint8))


def test_colmap2nerf_matches_jax_script(tmp_path):
    """tools/colmap2nerf against scripts/colmap2nerf.py (under JAX on the
    CPU) on the COLMAP model of the port's write_colmap_scene: the same
    transforms.json."""
    scene = str(tmp_path / "scene")
    syn.write_colmap_scene(scene, n_views=9, H=16, W=16, n_points=300)
    model = os.path.join(scene, "sparse", "0")
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "t.json")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "colmap2nerf.py"),
                    "--colmap_dir", model, "--images", "images",
                    "--out", want_path, "--aabb_scale", "8"],
                   check=True, cwd=REPO, capture_output=True, timeout=300,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    colmap2nerf.main(["--colmap_dir", model, "--images", "images",
                      "--out", got_path, "--aabb_scale", "8"])
    with open(got_path) as f, open(want_path) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    assert len(got["frames"]) == 9 and got["aabb_scale"] == 8
    assert got["frames"][0]["file_path"] == os.path.join("images", "v00.png")


_BENCH = r"""
import importlib.abc, json, os, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "sanerf_hq_tpu", "cv2",
           "transformers"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
from chip_smoke import rich_stage, script_runs
from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.tools import make_synth_scene
import sanerf_hq_tpu_torch.sam.build as B

# the tiny ViT of tests/test_torch_sam.py under the script's SAM_SIZE
B._CONFIGS["vit_b"] = lambda: dict(embed_dim=32, depth=2, num_heads=2,
                                   global_attn_indexes=(1,), window_size=3)
root = os.getcwd()
scene, ws = os.path.join(root, "rich_llff"), os.path.join(root, "ws")
# 6 views of 24x32 (held out: v000)
make_synth_scene.main([scene, "--n_views", "6", "--H", "24", "--W", "32"])
env = {"KIND": "rich", "SCENE": scene, "WS": ws, "FIELD": "mlp",
       "ITERS": "3", "SAM_SIZE": "vit_b", "DISTILL_ITERS": "2",
       "DISTILL_FLAGS": "--cache_size 2 --cache_interval 2 "
                        "--online_resolution 32 --feat_rank 8 --feat_res 16"}
small = ["--device", "cpu", "--num_steps", "16", "8", "8"]
cuts = {"stage1": ["--num_points", "512"],
        "stage3": ["--iters", "4", "--num_rays", "64",
                   "--online_resolution", "32", "--error_map_size", "8",
                   "--ray_pair_rgb_iter", "2"]}
out = []
for words in script_runs("bench_rich_scene.sh", env):
    assert words[0] == "main.py", words  # the scene exists: no writer line
    argv, stage = words[1:], rich_stage(words[1:])
    cli.build_parser().parse_args(argv)  # the script's own flag set parses
    t = cli.main(argv + small + cuts.get(stage, []))
    out.append({"stage": stage, "argv": argv, "step": t.state.step,
                "workspace": t.workspace, "frozen": t.backbone_frozen,
                "rays": t.cfg.num_rays})
print("RESULT " + json.dumps(out))
"""


def test_bench_rich_scene_flag_sets_run_without_jax_or_opencv(tmp_path):
    """scripts/bench_rich_scene.sh's command lines, read out of the script
    by chip_smoke.script_runs (FIELD=mlp, ITERS=3, SAM_SIZE=vit_b with the
    tiny ViT, DISTILL_ITERS=2), run in order through the port's CLI on the
    CPU over a small rich scene from the port's writer, with JAX, the JAX
    package, OpenCV and transformers blocked: stage 1, the SAM feature
    cache, stage 2b (distill), the decode, stage 3 on the GT decode-layout
    masks and its --test."""
    r = subprocess.run([sys.executable, "-c", _BENCH], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.split("RESULT ")[-1])
    stages = [x["stage"] for x in res]
    assert stages == ["stage1", "stage2", "distill", "decode", "stage3",
                      "stage3_test"]
    by = {x["stage"]: x for x in res}
    for x in res:  # $COMMON, unbraced, and the script's quoting
        assert x["argv"][:8] == [str(tmp_path / "rich_llff"), "--data_type",
                                 "llff", "--contract", "--bound", "128",
                                 "--min_near", "0.05"]
    assert "--num_rays" in by["stage1"]["argv"] and by["stage1"]["rays"] == 64
    assert by["stage1"]["step"] == 3 and by["distill"]["step"] == 2
    assert by["stage3"]["step"] == by["stage3_test"]["step"] == 4
    assert by["stage2"]["frozen"] and by["distill"]["frozen"]
    assert by["decode"]["frozen"] and by["stage3"]["frozen"]
    ws = tmp_path / "ws"
    for sub, step in (("rgb_mlp", 3), ("distill_mlp", 2), ("obj_mlp", 4)):
        assert (ws / sub / "checkpoints" / f"step_{step:08d}.pt").exists()
    stems = [f"v{i:03d}" for i in range(6)]
    assert sorted(os.listdir(ws / "sam_mlp" / "sam_cache")) == [
        f"{s}.npy" for s in stems]
    with open(ws / "sam_mlp" / "object_masks" / "valid_dict.json") as f:
        assert sorted(json.load(f)) == stems
    out = r.stdout
    assert "[EVAL] SSIM" in out and "[EVAL stage-2] MSE = " in out
    assert out.count("[EVAL] MeanIoU = ") == 2, out[-3000:]
    assert out.count("[decode] v") == 6
    probs = np.load(ws / "obj_mlp" / "results" / "v000_mask.npy")
    assert probs.shape == (24, 32, 2) and np.isfinite(probs).all()
