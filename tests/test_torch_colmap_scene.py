"""The port's COLMAP readers and its 'mip' / 'lerf' / 'others' loaders
against the JAX package on the CPU, with `resize_area` against OpenCV's
INTER_AREA and the synthetic COLMAP scene's geometry against its masks.

Inputs are made from seeds with numpy: the COLMAP model of
tests/test_data.py's `write_colmap_model`, and the sphere scene of
`write_colmap_scene`.  Bars: the readers exact, field by field; the
loaders' poses, intrinsics, cam_near_far, pts_aabb, scale and pts3d within
atol 1e-5; images within 1e-6 max abs (the JAX loader resizes with
OpenCV's INTER_AREA, the port with resize_area); resize_area within 1e-6
of OpenCV on float32 images.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from sanerf_hq_tpu.data import colmap as jcolmap
from sanerf_hq_tpu.data import provider as jprov
from sanerf_hq_tpu_torch.data import colmap as tcolmap
from sanerf_hq_tpu_torch.data import provider as tprov
from sanerf_hq_tpu_torch.data.png import write_png
from sanerf_hq_tpu_torch.data.rays import full_frame_rays
from sanerf_hq_tpu_torch.data.synthetic import (_sphere_hits,
                                                synthetic_cameras,
                                                write_colmap_scene)
from test_data import write_colmap_model

cv2 = pytest.importorskip("cv2")  # the JAX loader reads images with OpenCV


def _same(a, b):
    """Two reader outputs ({id: namedtuple}) equal field by field."""
    assert a.keys() == b.keys()
    for k in a:
        assert type(a[k]).__name__ == type(b[k]).__name__
        assert a[k]._fields == b[k]._fields
        for name, x, y in zip(a[k]._fields, a[k], b[k]):
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert np.asarray(x).dtype == np.asarray(y).dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                assert x == y, name


def _write_text_model(d, cams, imgs):
    """cameras.txt and images.txt of a binary model, as COLMAP writes
    them (observations line may be empty)."""
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in imgs.values():
            f.write(f"{im.id} " + " ".join(repr(float(v)) for v in im.qvec)
                    + " " + " ".join(repr(float(v)) for v in im.tvec)
                    + f" {im.camera_id} {im.name}\n")
            f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in
                             zip(im.xys.tolist(), im.point3D_ids)) + "\n")


def test_colmap_readers_match_jax(tmp_path, monkeypatch):
    # both load_sparse_model read through their native readers where a
    # compiler builds them (rgb as uint8); the Python readers are compared
    # here (the port's native reader against its Python one:
    # tests/test_torch_colmap_native.py)
    from sanerf_hq_tpu.data import colmap_native
    from sanerf_hq_tpu_torch.data import colmap_native as t_native

    monkeypatch.setattr(colmap_native, "native_available", lambda: False)
    monkeypatch.setattr(t_native, "compiler", lambda: None)
    d = str(tmp_path / "sparse")
    write_colmap_model(d)
    for fn, name in (("read_cameras_binary", "cameras.bin"),
                     ("read_images_binary", "images.bin"),
                     ("read_points3d_binary", "points3D.bin")):
        path = os.path.join(d, name)
        _same(getattr(tcolmap, fn)(path), getattr(jcolmap, fn)(path))
    _write_text_model(d, jcolmap.read_cameras_binary(d + "/cameras.bin"),
                      jcolmap.read_images_binary(d + "/images.bin"))
    for fn, name in (("read_cameras_text", "cameras.txt"),
                     ("read_images_text", "images.txt")):
        path = os.path.join(d, name)
        _same(getattr(tcolmap, fn)(path), getattr(jcolmap, fn)(path))
    # the binary model first; without it the text model and no points
    tb = tcolmap.load_sparse_model(d)
    for got, want in zip(tb, jcolmap.load_sparse_model(d)):
        _same(got, want)
    text = str(tmp_path / "text")
    os.makedirs(text)
    for name in ("cameras.txt", "images.txt"):
        shutil.copy(os.path.join(d, name), text)
    got, want = tcolmap.load_sparse_model(text), \
        jcolmap.load_sparse_model(text)
    assert got[2] == want[2] == {}
    _same(got[0], want[0])
    _same(got[1], want[1])
    rng = np.random.default_rng(0)
    for _ in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tcolmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_array_equal(tcolmap.rotmat2qvec(R),
                                      jcolmap.rotmat2qvec(R))


def _scenes_equal(got, want):
    assert (got.H, got.W) == (want.H, want.W)
    np.testing.assert_array_equal(got.img_names, want.img_names)
    for name in ("poses", "intrinsics", "cam_near_far", "pts_aabb", "pts3d"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
    assert got.scale == pytest.approx(want.scale, abs=1e-5)
    assert got.images.shape == want.images.shape
    assert got.images.dtype == np.float32
    assert np.abs(got.images - want.images).max() <= 1e-6
    for k in ("center", "R"):
        np.testing.assert_allclose(got.transforms[k], want.transforms[k],
                                   rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def colmap_scenes(tmp_path_factory):
    """A scene with images/ and images_2/, and one with images/ alone."""
    root = tmp_path_factory.mktemp("colmap")
    both, full = str(root / "both"), str(root / "full")
    write_colmap_scene(both, n_views=6, H=12, W=16, downscale=2,
                       n_points=300, seed=1)
    write_colmap_scene(full, n_views=6, H=30, W=20, downscale=1,
                       n_points=300, seed=2)
    return both, full


@pytest.mark.parametrize("enable_cam_center", [False, True])
@pytest.mark.parametrize("data_type", ["mip", "lerf"])
@pytest.mark.parametrize("case", ["ds1", "ds2_images_2", "ds2_resized"])
def test_load_colmap_scene_matches_jax(colmap_scenes, data_type,
                                       enable_cam_center, case):
    both, full = colmap_scenes
    root, ds = {"ds1": (both, 1), "ds2_images_2": (both, 2),
                "ds2_resized": (full, 2)}[case]
    got = tprov.load_scene(root, data_type, ds,
                           enable_cam_center=enable_cam_center)
    want = jprov.load_scene(root, data_type, ds,
                            enable_cam_center=enable_cam_center)
    _scenes_equal(got, want)
    assert got.cam_near_far.shape == (6, 2)
    assert (got.cam_near_far[:, 0] < got.cam_near_far[:, 1]).all()
    if case == "ds2_resized":  # 30 x 20 resized to 15 x 10
        assert got.images.shape == (6, 15, 10, 3)


def test_colmap_scene_views_see_the_sphere(colmap_scenes):
    """The loaded poses and intrinsics see the sphere where the written
    images (and write_sphere_masks) have it: rays of each view, through
    the rectified, scaled frame, hit the transformed sphere on exactly the
    mask's pixels."""
    both, _ = colmap_scenes
    s = tprov.load_scene(both, "mip", 2, enable_cam_center=True)
    t = s.transforms
    c = (t["R"][:3, :3] @ -t["center"])[[1, 0, 2]] * [1, 1, -1] * s.scale
    r = 0.5 * s.scale
    poses, intr = synthetic_cameras(6, 24, 32)
    for i in range(6):
        ro, rd = full_frame_rays(torch.from_numpy(s.poses[i]),
                                 torch.from_numpy(s.intrinsics[i]), s.H, s.W)
        ro, rd = ro.double().numpy(), rd.double().numpy()
        dn = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        oc = ro - c
        b = 2 * (dn * oc).sum(-1)
        hit = b * b - 4 * ((oc * oc).sum(-1) - r * r) > 0
        want, _ = _sphere_hits(poses[i], intr / 2, s.H, s.W, 0.5)
        assert want.sum() > 0
        np.testing.assert_array_equal(hit.reshape(s.H, s.W), want)
        # and the sparse points it observes lie in front of it
        assert s.cam_near_far[i, 0] > 0


def _write_others(root, form, n=5, H=18, W=22):
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "images_2"))
    names = [f"f{i:03d}.png" for i in range(n)]
    for name in names:
        write_png(os.path.join(root, "images_2", name),
                  rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
    poses = []
    for _ in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        pose = np.eye(4)
        pose[:3, :3] = jcolmap.qvec2rotmat(q)
        pose[:3, 3] = rng.normal(size=3) * 2
        poses.append((q, pose))
    if form == "metadata":
        K = [[0.9, 0.0, 0.5], [0.0, -1.1, 0.45], [0.0, 0.0, 1.0]]
        with open(os.path.join(root, "metadata.json"), "w") as f:
            json.dump({"camera": {
                "K": K, "positions": [p[:3, 3].tolist() for _, p in poses],
                "quaternions": [q.tolist() for q, _ in poses]}}, f)
        return
    os.makedirs(os.path.join(root, "pose"))
    os.makedirs(os.path.join(root, "intrinsic"))
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"),
               [[30.0, 0, 11.5, 0], [0, 31.0, 9.25, 0], [0, 0, 1, 0],
                [0, 0, 0, 1]])
    for name, (_, pose) in zip(names, poses):
        np.savetxt(os.path.join(root, "pose", name[:-3] + "txt"), pose)


@pytest.mark.parametrize("enable_cam_center", [False, True])
@pytest.mark.parametrize("form", ["metadata", "pose_dir"])
def test_load_others_matches_jax(tmp_path, form, enable_cam_center):
    root = str(tmp_path)
    _write_others(root, form)
    got = tprov.load_scene(root, "others", 2,
                           enable_cam_center=enable_cam_center)
    want = jprov.load_scene(root, "others", 2,
                            enable_cam_center=enable_cam_center)
    assert got.cam_near_far is None and got.pts3d is None
    _scenes_equal(got, want)
    assert got.images.shape == (5, 18, 22, 3)


@pytest.mark.parametrize("shape", [
    (64, 48, 32, 24),   # factor 2
    (64, 64, 16, 16),   # factor 4
    (45, 60, 15, 20),   # factor 3
    (100, 70, 37, 29),  # non-integer factors
    (33, 47, 10, 13),   # non-integer factors
    (10, 13, 33, 47),   # growing (OpenCV's area-style linear taps)
    (20, 30, 50, 20),   # one axis grows, the other shrinks
])
@pytest.mark.parametrize("channels", [None, 3, 4])
def test_resize_area_matches_opencv(shape, channels):
    h, w, H, W = shape
    rng = np.random.default_rng(h * w + (channels or 0))
    img = rng.uniform(size=(h, w) if channels is None
                      else (h, w, channels)).astype(np.float32)
    got = tprov.resize_area(img, H, W)
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


def test_jpeg_needs_opencv(tmp_path, monkeypatch):
    """A JPEG is read through OpenCV where it is importable; where it is
    not, the loader names the file and the missing decoder."""
    path = str(tmp_path / "v00.jpg")
    img = np.random.default_rng(4).integers(0, 256, (8, 10, 3), np.uint8)
    assert cv2.imwrite(path, img)
    got = tprov._load_image(path)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB) / 255.0
    assert got.shape == (8, 10, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-7)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"v00\.jpg.*OpenCV"):
        tprov._load_image(path)
