"""The port's viewer (`render/gui_api.py`, `render/web_viewer.py`) on the
CPU at the size of the JAX package's viewer test (3-level hash grids,
16x16 views, 32x32 frames):
  - OrbitCamera against JAX's over one sequence of orbit, scale, pan and
    fovy steps (1e-6);
  - render_frame and pick_point against JAX's InteractiveSession on a
    JAX-initialised hash-grid field carried across with params_from_jax,
    at the same pose, crop box and background (max abs < 2e-2 on image and
    depth, the bar of tests/test_torch_render.py; the picked point within
    2e-2 x depth of JAX's; picked_points.json equal after rounding);
  - every HTTP endpoint of JAX's viewer test, on port 0, with PNG frames
    (the decoded frame equal to render_frame's uint8 bit for bit);
  - SPP accumulation (counts, the mean of renders jittered by generators
    seeded 0, 1, 2, the reset on orbit) and training ticks (the step
    advances by the tick size; frames render the EMA weights, which ticks
    leave alone);
  - the CLI's --gui branch on the flag set of scripts/gui.sh, read from the
    script, with serve patched to port 0 and not blocking.
"""
import json
import os
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.config import Config as JaxConfig
from sanerf_hq_tpu.data import make_synthetic_dataset
from sanerf_hq_tpu.models import SANeRFField as JaxField
from sanerf_hq_tpu.ops import HashGridSpec as JaxSpec
from sanerf_hq_tpu.render.gui_api import InteractiveSession as JaxSession
from sanerf_hq_tpu.render.gui_api import OrbitCamera as JaxCamera
from sanerf_hq_tpu.train.trainer import Trainer as JaxTrainer
from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.png import decode_png
from sanerf_hq_tpu_torch.data.provider import Scene
from sanerf_hq_tpu_torch.data.synthetic import write_colmap_scene
from sanerf_hq_tpu_torch.models import SANeRFField, params_from_jax
from sanerf_hq_tpu_torch.models.convert import flatten
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
from sanerf_hq_tpu_torch.render import web_viewer
from sanerf_hq_tpu_torch.render.gui_api import InteractiveSession, OrbitCamera
from sanerf_hq_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32  # frames
MAIN = dict(num_levels=3, level_dim=2, base_resolution=8,
            log2_hashmap_size=10, desired_resolution=32)
PROP = dict(num_levels=2, level_dim=2, base_resolution=8,
            log2_hashmap_size=9, desired_resolution=16)
# background="white" composites bg_color over the residual transmittance
# (under "last_sample" the last sample takes it all, so the bg picker does
# nothing, as in the reference)
CFG = dict(num_steps=(8, 4, 2), num_rays=64, num_points=128, iters=10,
           bound=4.0, min_near=0.05, max_ray_batch=256, background="white")
# a crop box inside the field and a grey background for the comparisons
CROP = ([-1.0, -1.5, -1.0], [1.5, 1.0, 1.2])
BG = 0.25


def _specs(cls):
    return dict(main_spec=cls(**MAIN), prop_spec_0=cls(**PROP),
                prop_spec_1=cls(**PROP))


def _scene(cls):
    s = make_synthetic_dataset(n_views=2, H=16, W=16)
    return cls(images=s["images"], poses=s["poses"],
               intrinsics=s["intrinsics"], H=16, W=16,
               img_names=np.array(["a", "b"]))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX trainer and a port trainer over the same hash-grid field
    (tables of order 0.3, so that the renders depend on them)."""
    root = tmp_path_factory.mktemp("viewer")
    jcfg = JaxConfig(**CFG)
    jm = JaxField(grid_bound=jcfg.grid_bound, **_specs(JaxSpec))
    jt = JaxTrainer("t", jcfg, jm, str(root / "jax"),
                    use_checkpoint="scratch")
    rng = np.random.default_rng(0)
    p = dict(jax.device_get(jt.state.ema_params)["params"])
    for name in ("grid", "prop_grid_0", "prop_grid_1"):
        p[name] = rng.normal(size=p[name].shape).astype(np.float32) * 0.3
    jt.state = jt.state.replace(ema_params={"params": p})
    cfg = Config(**CFG, device="cpu")
    tm = SANeRFField(grid_bound=cfg.grid_bound, **_specs(HashGridSpec),
                     device="cpu")
    pt = Trainer("t", cfg, tm, str(root / "port"), resume=False)
    pt.state.load_weights(params_from_jax(flatten({"params": p})))
    return jt, pt, root


@pytest.fixture(scope="module")
def viewer(pair):
    _, pt, root = pair
    sess = InteractiveSession(pt, scene=_scene(Scene), W=HW, H=HW,
                              radius=3.0)
    server, state = web_viewer.serve(sess, port=0, block=False,
                                     points_path=str(root / "pts.json"))
    yield f"http://127.0.0.1:{server.server_address[1]}", sess, state
    server.shutdown()
    server.server_close()
    state.stop()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _post(base, path, obj):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _uint8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def test_orbit_camera_matches_jax():
    cams = OrbitCamera(48, 32, r=2.5, fovy=50), JaxCamera(48, 32, r=2.5,
                                                           fovy=50)
    steps = [("orbit", (40, -15)), ("scale", (2,)), ("pan", (30, -20, 5)),
             ("set_fovy", (75,)), ("orbit", (-120, 60)), ("scale", (-1,)),
             ("set_fovy", (200,)), ("pan", (-8, 4))]
    for name, args in steps:
        for c in cams:
            getattr(c, name)(*args)
        np.testing.assert_allclose(cams[0].pose, cams[1].pose, atol=1e-6)
        np.testing.assert_allclose(cams[0].intrinsics, cams[1].intrinsics,
                                   atol=1e-6)
    assert cams[0].version == cams[1].version == len(steps)
    assert cams[0].fovy == 120.0


def test_render_frame_and_pick_match_jax(pair, tmp_path):
    jt, pt, _ = pair
    sj = JaxSession(jt, W=HW, H=HW, radius=3.0)
    sp = InteractiveSession(pt, W=HW, H=HW, radius=3.0)
    for s in (sj, sp):
        s.camera.orbit(60, -25)
        s.set_aabb(*CROP)
        s.bg_color = BG
    want, got = sj.render_frame(), sp.render_frame()
    for k in ("image", "depth"):
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        assert err < 2e-2, f"{k}: max abs {err}"
    # the crop and the background show: not a blank frame
    assert got["image"].std() > 0.02
    for (x, y, label) in ((16, 16, 1), (9, 20, 0)):
        pj, pp = sj.pick_point(x, y, label), sp.pick_point(x, y, label)
        depth = float(got["depth"][y, x])
        assert np.linalg.norm(pp - pj) <= 2e-2 * depth
    saved = []
    for s, name in ((sj, "j.json"), (sp, "p.json")):
        s.save_points(str(tmp_path / name))
        with open(tmp_path / name) as f:
            saved.append(json.load(f))
    for d in saved:
        d["points"] = np.round(d["points"], 2).tolist()
    assert saved[0] == saved[1]
    assert saved[1]["negative_labels"] == [1]
    assert saved[1]["valid_threshold"] == -1
    assert saved[1]["crucial_point_index"] == []


def test_index_and_frame_are_png_of_render_frame(viewer):
    base, sess, _ = viewer
    code, _, body = _get(base, "/")
    assert code == 200 and b"<canvas" in body
    code, headers, body = _get(base, "/frame?ds=2")
    assert code == 200
    assert headers["Content-Type"] == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    assert float(headers["X-FPS"]) > 0
    assert json.loads(headers["X-Points"]) == []
    frame = decode_png(body)
    assert frame.shape == (HW // 2, HW // 2, 3)
    np.testing.assert_array_equal(
        frame, _uint8(sess.render_frame(downscale=2)["image"]))


def test_right_drag_pan_flag(viewer):
    base, sess, _ = viewer
    _, _, body = _get(base, "/")
    assert b"RIGHT_DRAG_PAN=false" in body
    server2, state2 = web_viewer.serve(sess, port=0, block=False,
                                       right_drag_pan=True)
    try:
        base2 = f"http://127.0.0.1:{server2.server_address[1]}"
        _, _, body2 = _get(base2, "/")
        assert b"RIGHT_DRAG_PAN=true" in body2
    finally:
        server2.shutdown()
        server2.server_close()
        state2.stop()


def test_orbit_scale_pan_change_camera(viewer):
    base, sess, _ = viewer
    pose0 = sess.camera.pose.copy()
    v0 = sess.camera.version
    for path, body in (("/orbit", {"dx": 50, "dy": 0}),
                       ("/scale", {"delta": 1}),
                       ("/pan", {"dx": 10, "dy": 5})):
        assert _post(base, path, body) == (200, {"ok": True})
    assert sess.camera.version == v0 + 3
    assert not np.allclose(sess.camera.pose, pose0)


def test_click_picks_point_and_saves(viewer, tmp_path):
    base, sess, state = viewer
    code, out = _post(base, "/click", {"x": 0.5, "y": 0.5, "label": 1})
    assert code == 200 and out["point"] is not None and len(out["point"]) == 3
    pts = state.projected_points()
    assert len(pts) == 1
    assert abs(pts[0][0] - 0.5) < 0.1 and abs(pts[0][1] - 0.5) < 0.1
    code, out = _post(base, "/click", {"x": 0.25, "y": 0.5, "label": 0})
    assert out["point"] is not None
    p = str(tmp_path / "picked.json")
    code, out = _post(base, "/save_points", {"path": p})
    assert code == 200 and out["n"] == 2
    with open(p) as f:
        saved = json.load(f)
    assert len(saved["points"]) == 2 and saved["negative_labels"] == [1]
    # the same pixels again toggle the points off
    for x in (0.5, 0.25):
        assert _post(base, "/click", {"x": x, "y": 0.5})[1]["point"] is None
    assert sess.points_3d == [] and sess.point_labels == []


def test_status_endpoint(viewer):
    base, _, _ = viewer
    code, _, body = _get(base, "/status")
    st = json.loads(body)
    assert code == 200 and st["training"] is False
    assert st["bound"] == 4.0 and st["spp"] == 1 and st["fovy"] == 60.0
    assert st["aabb"] is None and st["n_points"] == 0
    with pytest.raises(urllib.error.HTTPError):
        _get(base, "/nothing")


def test_fovy_slider(viewer):
    base, sess, _ = viewer
    f0 = np.asarray(sess.camera.intrinsics).copy()
    _post(base, "/fovy", {"value": 90})
    assert sess.camera.fovy == 90.0
    assert sess.camera.intrinsics[0] < f0[0]
    _post(base, "/fovy", {"value": 60})


def test_bg_color_changes_background(viewer):
    base, sess, _ = viewer
    _post(base, "/aabb", {"min": [-0.01] * 3, "max": [0.01] * 3})
    _post(base, "/bg", {"value": 0.0})
    f_black = sess.render_frame(downscale=2)["image"]
    _post(base, "/bg", {"value": 1.0})
    f_white = sess.render_frame(downscale=2)["image"]
    _post(base, "/aabb", {"reset": True})
    assert f_black.mean() < f_white.mean() - 0.3


def test_aabb_crop(viewer):
    base, sess, _ = viewer
    code, out = _post(base, "/aabb", {"min": [-0.01, -0.01, -0.01],
                                      "max": [0.01, 0.01, 0.01]})
    assert code == 200 and np.allclose(sess.aabb[:3], -0.01)
    full = sess.trainer.render_view(sess.camera.pose, sess.camera.intrinsics,
                                    HW, HW)
    f_crop = sess.render_frame()
    # everything outside the tiny box is cropped: a background-only frame
    img = np.clip(f_crop["image"], 0, 1)
    assert float(np.abs(img - 1.0).max()) < 0.05
    assert np.isfinite(f_crop["depth"]).all()
    assert float(full["weights_sum"].max()) > 0.1  # the uncropped field
    _post(base, "/aabb", {"reset": True})
    assert sess.aabb is None


def test_spp_accumulates_jittered_renders(viewer):
    base, sess, _ = viewer
    _post(base, "/spp", {"value": 3})
    assert sess.spp == 3
    frames = [sess.render_frame(downscale=2) for _ in range(4)]
    assert [f["spp"] for f in frames] == [1, 2, 3, 3]
    cam = sess.camera
    intr = cam.intrinsics / 2
    intr[2], intr[3] = HW // 4, HW // 4
    renders = []
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        renders.append(sess.trainer.render_view(
            cam.pose, intr, HW // 2, HW // 2, generator=g)["image"].reshape(
                HW // 2, HW // 2, 3))
    want = np.mean(renders, axis=0)
    np.testing.assert_allclose(frames[2]["image"], want, rtol=0, atol=1e-6)
    assert frames[3]["image"] is frames[2]["image"]  # served, not rendered
    assert not np.array_equal(renders[0], renders[1])  # jittered
    _post(base, "/orbit", {"dx": 20, "dy": 0})
    assert sess.render_frame(downscale=2)["spp"] == 1
    _post(base, "/spp", {"value": 1})


def test_trajectory_record_save(viewer, tmp_path):
    base, sess, _ = viewer
    _post(base, "/clear_trajectory", {})
    assert _post(base, "/record_pose", {})[1]["n_keyframes"] == 1
    _post(base, "/orbit", {"dx": 80, "dy": 10})
    assert _post(base, "/record_pose", {})[1]["n_keyframes"] == 2
    p = str(tmp_path / "traj.json")
    code, out = _post(base, "/save_trajectory", {"path": p})
    assert out["n_keyframes"] == 2
    from sanerf_hq_tpu_torch.data.trajectory import load_recorded_trajectories

    poses, intr, names = load_recorded_trajectories(str(tmp_path),
                                                    interp_frames=3)
    assert poses.shape == (4, 4, 4)
    np.testing.assert_allclose(poses[0], sess.trajectory[0], atol=1e-5)
    np.testing.assert_allclose(poses[-1], sess.trajectory[1], atol=1e-5)


def test_training_ticks_advance_the_step_not_the_frames(viewer):
    base, sess, state = viewer
    before = sess.render_frame(downscale=2)["image"].copy()
    step = sess.trainer.state.step
    for target in (0.05, 0.05):
        n = sess._train_steps
        out = sess.train_ticks(target_seconds=target)
        assert out["steps"] == n and out["step"] == step + n
        assert np.isfinite(out["loss"]) and out["steps_per_sec"] > 0
        assert 1 <= sess._train_steps <= 256
        step = out["step"]
    # frames render the EMA weights, which ticks do not update
    np.testing.assert_array_equal(sess.render_frame(downscale=2)["image"],
                                  before)
    # the training thread runs ticks while /train is on
    _post(base, "/train", {"on": True})
    try:
        for _ in range(600):
            if state.last_train["step"] > step:
                break
            time.sleep(0.05)
    finally:
        _post(base, "/train", {"on": False})
    with state.lock:  # the current tick ends before the lock is free
        assert state.last_train["step"] > step
        assert json.loads(_get(base, "/status")[2])["step"] > step


def test_cli_gui_branch_serves_on_the_flags_of_gui_sh(tmp_path, monkeypatch):
    sys.path.insert(0, REPO)
    from chip_smoke import script_argv

    env = {"SANERFHQ_DATA_PATH": str(tmp_path / "scene"),
           "SANERFHQ_WORKSPACE_ROOT": str(tmp_path / "ws"),
           "SANERFHQ_SCENE": "sphere"}
    write_colmap_scene(env["SANERFHQ_DATA_PATH"], n_views=17, H=16, W=16,
                       downscale=4, n_points=400)
    argv = script_argv("gui.sh", env)
    assert argv[argv.index("--H") + 1] == argv[argv.index("--W") + 1] == "512"
    assert "--gui" in argv and "--test" in argv
    started = {}
    real_serve = web_viewer.serve

    def serve(session, **kw):
        kw.update(port=0, block=False)
        started["server"], started["state"] = real_serve(session, **kw)
        started["kw"] = kw
        return started["server"], started["state"]

    monkeypatch.setattr(web_viewer, "serve", serve)
    # the published hash grid on the CPU: 32x32 frames, fewer samples
    trainer = cli.main(argv + ["--device", "cpu", "--num_steps", "16", "8",
                               "8", "--H", str(HW), "--W", str(HW)])
    server, state = started["server"], started["state"]
    try:
        sess = state.session
        assert sess.scene is None  # --test: no training ticks
        assert sess.trainer is trainer
        assert (sess.camera.W, sess.camera.H, sess.camera.radius,
                sess.camera.fovy) == (HW, HW, 0.5, 60)
        assert started["kw"]["points_path"] == os.path.join(
            env["SANERFHQ_WORKSPACE_ROOT"], "rgb_nerf", "sphere",
            "picked_points.json")
        base = f"http://127.0.0.1:{server.server_address[1]}"
        _, headers, body = _get(base, "/frame?ds=4")
        assert headers["Content-Type"] == "image/png"
        np.testing.assert_array_equal(
            decode_png(body), _uint8(sess.render_frame(downscale=4)["image"]))
        code, out = _post(base, "/click", {"x": 0.5, "y": 0.5})
        assert code == 200 and np.isfinite(out["point"]).all()
        _post(base, "/save_points", {})
        with open(started["kw"]["points_path"]) as f:
            assert len(json.load(f)["points"]) == 1
    finally:
        server.shutdown()
        server.server_close()
        state.stop()
