"""The port's native COLMAP reader (data/colmap_native.py over
sanerf_hq_tpu_torch/csrc/colmap_reader.cpp), built here with g++:
  - a binary model written by this test (two cameras of different models,
    images with 2-D points, points with tracks) read through
    load_sparse_model (the native reader, a compiler being on the PATH)
    equals the Python binary readers field by field;
  - the same model written as text reads through load_sparse_model (the
    Python text readers) to the same cameras and images;
  - the two readers' fields have the same types and dtypes;
  - an image name longer than 511 bytes raises;
  - a truncated cameras.bin, images.bin or points3D.bin raises, through
    load_sparse_model too (no fallback); a source that does not compile
    raises; only a missing compiler selects the Python reader, and that is
    printed.
"""
import os
import struct

import numpy as np
import pytest

from sanerf_hq_tpu_torch.data import colmap, colmap_native
from sanerf_hq_tpu_torch.data.colmap import load_sparse_model

CAMS = [(1, 1, 64, 48, [50.0, 51.0, 32.0, 24.0]),  # PINHOLE
        (7, 4, 80, 60, [60.0, 61.0, 40.0, 30.0, 0.01, -0.02, 1e-3, 2e-3])]


def _model(seed=0):
    rng = np.random.default_rng(seed)
    images = []
    for i in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        # at least one 2-D point: the text readers drop blank lines, as
        # JAX's do, so an image without points has no text form here
        n2d = int(rng.integers(1, 9))
        images.append((i + 3, q, rng.normal(size=3), CAMS[i % 2][0],
                       f"img_{i:03d}.png", rng.uniform(0, 60, (n2d, 2)),
                       rng.integers(-1, 40, n2d)))
    points = []
    for p in range(40):
        tl = int(rng.integers(0, 5))
        points.append((p + 1, rng.normal(size=3),
                       rng.integers(0, 256, 3), float(rng.uniform(0, 2)),
                       rng.integers(1, 6, tl), rng.integers(0, 9, tl)))
    return images, points


def _write_binary(d, images, points):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(CAMS)))
        for cid, mid, w, h, params in CAMS:
            f.write(struct.pack("<iiQQ", cid, mid, w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, q, t, cid, name, xys, ids in images:
            f.write(struct.pack("<i4d3di", iid, *q, *t, cid))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(xys)))
            for (x, y), pid in zip(xys, ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, xyz, rgb, err, tids, tidx in points:
            f.write(struct.pack("<Q3d3Bd", pid, *xyz, *map(int, rgb), err))
            f.write(struct.pack("<Q", len(tids)))
            for a, b in zip(tids, tidx):
                f.write(struct.pack("<ii", int(a), int(b)))


def _write_text(d, images):
    os.makedirs(d, exist_ok=True)
    names = {m.model_id: m.model_name for m in colmap.CAMERA_MODELS}
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# camera list\n")
        for cid, mid, w, h, params in CAMS:
            f.write(f"{cid} {names[mid]} {w} {h} "
                    + " ".join(repr(p) for p in params) + "\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# image list\n")
        for iid, q, t, cid, name, xys, ids in images:
            f.write(f"{iid} " + " ".join(repr(float(v)) for v in (*q, *t))
                    + f" {cid} {name}\n")
            f.write(" ".join(f"{float(x)!r} {float(y)!r} {int(p)}"
                             for (x, y), p in zip(xys, ids)) + "\n")


def _assert_equal(a, b, types=False):
    """Two dicts of the readers' namedtuples, field by field; with types,
    each field's type and dtype too."""
    assert a.keys() == b.keys()
    for k in a:
        assert a[k]._fields == b[k]._fields
        for f, x, y in zip(a[k]._fields, a[k], b[k]):
            if types:
                assert type(x) is type(y), (k, f, type(x), type(y))
                assert getattr(x, "dtype", None) == getattr(y, "dtype",
                                                            None), (k, f)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                x, y = np.asarray(x), np.asarray(y)
                assert x.shape == y.shape, (k, f)
                np.testing.assert_array_equal(x, y, err_msg=f"{k}.{f}")
            else:
                assert x == y, (k, f, x, y)


@pytest.fixture()
def model_dirs(tmp_path):
    images, points = _model()
    binary, text = str(tmp_path / "bin"), str(tmp_path / "txt")
    _write_binary(binary, images, points)
    _write_text(text, images)
    return binary, text


def test_native_reader_equals_python_reader(model_dirs, capsys):
    binary, _ = model_dirs
    assert colmap_native.build().exists()
    cams, imgs, pts = load_sparse_model(binary)
    assert "no C++ compiler" not in capsys.readouterr().out
    _assert_equal(cams, colmap.read_cameras_binary(
        os.path.join(binary, "cameras.bin")), types=True)
    _assert_equal(imgs, colmap.read_images_binary(
        os.path.join(binary, "images.bin")), types=True)
    _assert_equal(pts, colmap.read_points3d_binary(
        os.path.join(binary, "points3D.bin")), types=True)
    assert len(cams) == 2 and len(imgs) == 5 and len(pts) == 40
    assert imgs[3].name == "img_000.png" and cams[7].model == "OPENCV"


def test_text_model_reads_as_the_binary_one(model_dirs):
    binary, text = model_dirs
    cams_b, imgs_b, _ = load_sparse_model(binary)
    cams_t, imgs_t, pts_t = load_sparse_model(text)
    assert pts_t == {}
    _assert_equal(cams_t, colmap.read_cameras_text(
        os.path.join(text, "cameras.txt")))
    _assert_equal(cams_t, cams_b)
    _assert_equal(imgs_t, imgs_b)


@pytest.mark.parametrize("name", ["cameras.bin", "images.bin",
                                  "points3D.bin"])
def test_truncated_file_raises(model_dirs, name):
    binary, _ = model_dirs
    path = os.path.join(binary, name)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) - 5])
    with pytest.raises(OSError, match="native COLMAP reader"):
        load_sparse_model(binary)


def test_long_image_name_raises(tmp_path):
    """A name longer than the reader's 511 bytes raises; one of 511 reads
    whole."""
    images, points = _model()
    for n, ok in ((511, True), (512, False)):
        d = str(tmp_path / str(n))
        long_name = "x" * (n - 4) + ".png"
        _write_binary(d, [images[0][:4] + (long_name,) + images[0][5:]]
                      + images[1:], points)
        if ok:
            assert load_sparse_model(d)[1][3].name == long_name
        else:
            with pytest.raises(OSError, match="longer than 511 bytes"):
                load_sparse_model(d)


def test_failed_build_raises_and_no_compiler_reads_in_python(
        model_dirs, tmp_path, monkeypatch, capsys):
    binary, _ = model_dirs
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(colmap_native, "SOURCE", bad)
    monkeypatch.setattr(colmap_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed on bad.cpp"):
        colmap_native.build()
    monkeypatch.setattr(colmap_native, "compiler", lambda: None)
    cams, imgs, pts = load_sparse_model(binary)
    assert "no C++ compiler on the PATH" in capsys.readouterr().out
    _assert_equal(imgs, colmap.read_images_binary(
        os.path.join(binary, "images.bin")))
    assert len(pts) == 40
