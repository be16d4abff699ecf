"""The port's trajectory poses (`data/trajectory.py`), pose dump
(`utils/vis_pose.py`), overlays and incoherent mask (`utils/overlays.py`)
against the JAX package on the same numpy inputs, made from a seed; and
the tracer and seeding of `utils/profiling.py`.

Bars: poses and intrinsics 1e-6 abs; the PLY byte for byte; overlays and
the incoherent mask exact (JAX's resizes are OpenCV's; the port's numpy
resizes are within two fp32 roundings of them).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from sanerf_hq_tpu.data import trajectory as jtraj
from sanerf_hq_tpu.utils import overlays as joverlays
from sanerf_hq_tpu.utils import vis_pose as jvis
from sanerf_hq_tpu_torch.data import trajectory as traj
from sanerf_hq_tpu_torch.data.colmap import qvec2rotmat
from sanerf_hq_tpu_torch.data.provider import resize_linear
from sanerf_hq_tpu_torch.utils import overlays, profiling, vis_pose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q = rng.normal(size=4)
        out[i, :3, :3] = qvec2rotmat(q / np.linalg.norm(q))
        out[i, :3, 3] = rng.normal(size=3) * 2
    return out


@pytest.mark.parametrize("n,frames", [(2, 8), (5, 3), (3, 1)])
def test_interpolate_poses_matches_jax(n, frames):
    p = _poses(n, seed=n)
    got, want = traj.interpolate_poses(p, frames), jtraj.interpolate_poses(
        p, frames)
    assert got.shape == want.shape == ((n - 1) * (frames + 1), 4, 4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the ends are the keyframes
    np.testing.assert_allclose(got[0], p[0], atol=1e-5)
    np.testing.assert_allclose(got[frames], p[1], atol=1e-5)


def test_slerp_matches_jax_on_both_branches():
    rng = np.random.default_rng(1)
    q0 = rng.normal(size=4)
    q0 /= np.linalg.norm(q0)
    for q1 in (-q0 + 1e-4, rng.normal(size=4)):  # near and far (and d < 0)
        q1 = q1 / np.linalg.norm(q1)
        for t in (0.0, 0.3, 1.0):
            np.testing.assert_allclose(traj.slerp(q0, q1, t),
                                       jtraj.slerp(q0, q1, t), atol=1e-12)


def test_circle_and_synthesized_poses_match_jax():
    np.testing.assert_allclose(
        traj.circle_poses(1.7, 0.2, 12, center=(0.1, 0.0, -0.2)),
        jtraj.circle_poses(1.7, 0.2, 12, center=(0.1, 0.0, -0.2)), atol=1e-6)
    train = _poses(15, seed=3)
    for kind, count in (("interp", 14 * 5), ("circle", 60)):
        got = traj.synthesize_test_poses(train, kind)
        assert got.shape == (count, 4, 4)
        np.testing.assert_allclose(
            got, jtraj.synthesize_test_poses(train, kind), atol=1e-6)


def test_recorded_trajectories_match_jax(tmp_path):
    for i, n in enumerate((2, 3)):
        with open(tmp_path / f"t{i}.json", "w") as f:
            json.dump({"trajectory": _poses(n, seed=10 + i).tolist()}, f)
    got = traj.load_recorded_trajectories(str(tmp_path))
    want = jtraj.load_recorded_trajectories(str(tmp_path))
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == (9 + 18, 4, 4)
    assert list(got[2][:2]) == ["0000_0000", "0000_0001"]
    assert got[2][-1] == "0001_0017"
    np.testing.assert_allclose(got[1], [886.8103, 886.8103, 512, 512],
                               rtol=1e-6)


@pytest.mark.parametrize("bound,points", [(2.0, 7), (1.0, 0)])
def test_vis_pose_ply_matches_jax_byte_for_byte(tmp_path, monkeypatch, bound,
                                                points):
    # without matplotlib: the PLY alone
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    poses = _poses(4, seed=5)
    pts = (np.random.default_rng(6).normal(size=(points, 3))
           if points else None)
    got = vis_pose.visualize_poses(poses, bound=bound, points=pts,
                                   out_path=str(tmp_path / "p.ply"))
    want = jvis.visualize_poses(poses, bound=bound, points=pts,
                                out_path=str(tmp_path / "j.ply"))
    with open(got, "rb") as a, open(want, "rb") as b:
        body = a.read()
        assert body == b.read()
    n_segs = 9 * 4 + 12 + (12 if bound > 1 else 0)
    assert f"element vertex {2 * n_segs + points}\n".encode() in body
    assert f"element edge {n_segs}\n".encode() in body
    assert not (tmp_path / "p.ply.png").exists()


def test_overlays_match_jax():
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(9, 13, 3)).astype(np.float32)
    prob = rng.uniform(-0.2, 1.2, size=(9, 13)).astype(np.float32)
    mask = prob > 0.5
    np.testing.assert_array_equal(overlays.overlay_mask_only(mask),
                                  joverlays.overlay_mask_only(mask))
    np.testing.assert_array_equal(overlays.overlay_mask_heatmap(img, prob),
                                  joverlays.overlay_mask_heatmap(img, prob))
    np.testing.assert_array_equal(
        overlays.overlay_mask_composition(img, mask, 0.25),
        joverlays.overlay_mask_composition(img, mask, 0.25))


@pytest.mark.parametrize("shape", [(32, 48), (17, 23), (3, 15, 9)])
@pytest.mark.parametrize("sfact", [2, 3])
def test_incoherent_mask_matches_opencv(shape, sfact):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(shape) + sfact)
    binary = (rng.uniform(size=shape) > 0.6).astype(np.float32)
    soft = rng.uniform(size=shape).astype(np.float32)
    for m in (binary, soft):
        got = overlays.get_incoherent_mask(m, sfact)
        want = joverlays.get_incoherent_mask(m, sfact)  # cv2.resize
        assert got.shape == want.shape == m.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the shrink itself, OpenCV's float INTER_LINEAR
    h, w = shape[-2:]
    small = cv2.resize(soft.reshape(-1, h, w)[0], (w // sfact, h // sfact),
                       interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(
        resize_linear(soft.reshape(-1, h, w)[0], h // sfact, w // sfact),
        small, rtol=0, atol=2.5e-7)


def test_profiling_helpers_on_the_cpu(tmp_path):
    """The tracer on the CPU (spans; device times and syncs noted as not
    measured) and seed_everything."""
    g = profiling.seed_everything(3, device="cpu")
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(3)))
    tracer = profiling.enable()
    try:
        with profiling.span("sanerf.view") as rec:
            torch.ones(8).sum()
        assert rec.path == "sanerf.view"
        snap = profiling.snapshot()
        view = snap["spans"]["sanerf.view"]
        assert view["calls"] == 1 and view["host_ms"] >= 0
        assert view["device_ms"] is None and view["syncs"] is None
        assert snap["device"] == "cpu" and snap["notes"] == [
            "device times not measured and syncs not counted: no CUDA "
            "device"]
        profiling.write(str(tmp_path / "spans.json"))
        assert (tmp_path / "spans.trace.json").exists()
    finally:
        assert profiling.disable() is tracer
    with pytest.raises(RuntimeError, match="tracer is off"):
        profiling.snapshot()
    with profiling.span("sanerf.view") as rec:
        assert rec is None


_CLI = r"""
import functools, importlib.abc, json, os, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "sanerf_hq_tpu", "cv2",
           "imageio", "matplotlib"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data import trajectory
from sanerf_hq_tpu_torch.data.synthetic import write_colmap_scene

write_colmap_scene("scene", n_views=17, H=8, W=8, downscale=4, n_points=300)
# the replay's 1024x1024 camera cut to 16x16 for the CPU
trajectory.load_recorded_trajectories = functools.partial(
    trajectory.load_recorded_trajectories, resolution=16)
keys = [np.eye(4), np.eye(4)]
keys[1][:3, 3] = [0.3, 0.1, 0.2]
os.makedirs("traj")
with open("traj/t.json", "w") as f:
    json.dump({"trajectory": [k.tolist() for k in keys]}, f)
base = ["scene", "--data_type", "mip", "--downscale", "4",
        "--enable_cam_center", "--field_type", "mlp", "--cp_rank", "8",
        "--cp_res", "32", "--num_steps", "8", "8", "8", "--device", "cpu"]
out = {}
for tag, flags in (("interp", ["--test", "--render_trajectory"]),
                   ("circle", ["--test", "--circle"]),
                   ("replay", ["--test", "--trajectory_root", "traj"]),
                   ("vis_pose", ["--test", "--vis_pose", "--workspace",
                                 "ws_vis"])):
    ws = "ws_" + tag
    cli.main(base + ["--workspace", ws] + flags)
    d = os.path.join(ws, "trajectory")
    out[tag] = sorted(os.listdir(d)) if os.path.isdir(d) else None
with open("ws_vis/poses.ply") as f:
    out["ply_header"] = [next(f).strip() for _ in range(12)]
print("RESULT " + json.dumps(out))
"""


def test_cli_trajectories_and_vis_pose_without_jax_opencv_imageio(tmp_path):
    """--test --render_trajectory (interp along the 15 training cameras:
    60 // 14 = 4, so 14 x 5 frames), --test --circle (60 frames), --test
    --trajectory_root (2 keyframes: 9 frames, its camera cut to 16x16) and
    --vis_pose through cli.main on a COLMAP scene, in a process where JAX,
    the JAX package, OpenCV, imageio and matplotlib cannot be imported:
    the frames stay, the video is left out with a warning, and the PLY has
    9 segments a camera and the two boxes (bound 128) and the sparse
    points."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CLI], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("[WARN] video write failed (blocked import of "
                          "imageio); saving frames only") == 3
    res = json.loads(r.stdout.split("RESULT ")[-1])
    for tag, names in (("interp", [f"traj_{i:04d}" for i in range(70)]),
                       ("circle", [f"traj_{i:04d}" for i in range(60)]),
                       ("replay", [f"0000_{i:04d}" for i in range(9)])):
        assert res[tag] == sorted(f"{n}_{kind}" for n in names
                                  for kind in ("depth.npy", "rgb.png")), tag
    assert res["vis_pose"] is None  # the pose dump, then the --test render
    n_segs = 9 * 17 + 12 + 12
    assert res["ply_header"][2] == f"element vertex {2 * n_segs + 300}"
    assert res["ply_header"][9] == f"element edge {n_segs}"
