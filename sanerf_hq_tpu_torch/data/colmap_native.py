"""ctypes bindings of the native COLMAP binary reader
(`sanerf_hq_tpu_torch/csrc/colmap_reader.cpp`, host C++).

At first use the source is built with `g++ -O3 -shared -fPIC` into
`build/libcolmap_reader_<hash>.so` at the repository root (the hash covers
the source and the flags, so an edit rebuilds).  A failed build raises,
and so does a failed read: nothing here falls back to the Python readers.
`data/colmap.py` `load_sparse_model` takes this reader for a binary model
whenever a C++ compiler is on the PATH (`compiler()`), and the Python
readers only when none is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .colmap import MODEL_BY_ID, Camera, Image, Point3D

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "colmap_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None


def compiler() -> Optional[str]:
    """The C++ compiler on the PATH (g++, else c++), or None."""
    return shutil.which("g++") or shutil.which("c++")


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libcolmap_reader_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The built library, compiled first if it is not up to date."""
    target = _target()
    if target.exists():
        return target
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    r = subprocess.run([cxx, *FLAGS, "-o", tmp, str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{r.stderr}")
    os.replace(tmp, target)  # atomic: no reader sees a partial file
    return target


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.read_cameras_bin.restype = ctypes.c_longlong
        lib.probe_images_bin.restype = ctypes.c_int
        lib.read_images_bin.restype = ctypes.c_longlong
        lib.probe_points3d_bin.restype = ctypes.c_int
        lib.read_points3d_bin.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(rc: int, what: str, path: str):
    if rc < 0:
        raise OSError(f"native COLMAP reader: {what} failed on {path}")


def read_cameras_native(path: str) -> Dict[int, Camera]:
    lib = _load()
    cap = 1 << 16
    ids = np.zeros(cap, np.int32)
    model_ids = np.zeros(cap, np.int32)
    widths = np.zeros(cap, np.int64)
    heights = np.zeros(cap, np.int64)
    params = np.zeros(cap * 12, np.float64)
    offs = np.zeros(cap + 1, np.int64)
    n = lib.read_cameras_bin(path.encode(), cap, params.size, _ptr(ids),
                             _ptr(model_ids), _ptr(widths), _ptr(heights),
                             _ptr(params), _ptr(offs))
    _check(n, "read_cameras_bin", path)
    cams = {}
    for i in range(n):
        model = MODEL_BY_ID[int(model_ids[i])]
        cams[int(ids[i])] = Camera(int(ids[i]), model.model_name,
                                   int(widths[i]), int(heights[i]),
                                   params[offs[i]:offs[i + 1]].copy())
    return cams


def read_images_native(path: str) -> Dict[int, Image]:
    lib = _load()
    counts = np.zeros(2, np.int64)
    _check(lib.probe_images_bin(path.encode(), _ptr(counts)),
           "probe_images_bin", path)
    n, total2d = int(counts[0]), int(counts[1])
    cap_name = 512
    ids = np.zeros(n, np.int32)
    qvecs = np.zeros((n, 4), np.float64)
    tvecs = np.zeros((n, 3), np.float64)
    cam_ids = np.zeros(n, np.int32)
    names = np.zeros(n * cap_name, np.uint8)
    p2d_offs = np.zeros(n + 1, np.int64)
    xys = np.zeros((max(total2d, 1), 2), np.float64)
    p3d = np.zeros(max(total2d, 1), np.int64)
    r = lib.read_images_bin(path.encode(), n, total2d, cap_name, _ptr(ids),
                            _ptr(qvecs), _ptr(tvecs), _ptr(cam_ids),
                            _ptr(names), _ptr(p2d_offs), _ptr(xys), _ptr(p3d))
    if r == -2:
        raise OSError(f"native COLMAP reader: an image name in {path} is "
                      f"longer than {cap_name - 1} bytes")
    _check(r, "read_images_bin", path)
    images = {}
    name_rows = names.reshape(n, cap_name)
    for i in range(n):
        raw = name_rows[i].tobytes()
        s, e = p2d_offs[i], p2d_offs[i + 1]
        images[int(ids[i])] = Image(
            int(ids[i]), qvecs[i].copy(), tvecs[i].copy(), int(cam_ids[i]),
            raw[:raw.index(b"\x00")].decode("utf-8"), xys[s:e].copy(),
            p3d[s:e].copy())
    return images


def read_points3d_native(path: str) -> Dict[int, Point3D]:
    lib = _load()
    counts = np.zeros(2, np.int64)
    _check(lib.probe_points3d_bin(path.encode(), _ptr(counts)),
           "probe_points3d_bin", path)
    n, total_track = int(counts[0]), int(counts[1])
    ids = np.zeros(n, np.int64)
    xyzs = np.zeros((n, 3), np.float64)
    rgbs = np.zeros((n, 3), np.uint8)
    errors = np.zeros(n, np.float64)
    offs = np.zeros(n + 1, np.int64)
    tids = np.zeros(max(total_track, 1), np.int32)
    tidx = np.zeros(max(total_track, 1), np.int32)
    r = lib.read_points3d_bin(path.encode(), n, total_track, _ptr(ids),
                              _ptr(xyzs), _ptr(rgbs), _ptr(errors),
                              _ptr(offs), _ptr(tids), _ptr(tidx))
    _check(r, "read_points3d_bin", path)
    pts = {}
    for i in range(n):
        s, e = offs[i], offs[i + 1]
        pts[int(ids[i])] = Point3D(int(ids[i]), xyzs[i].copy(),
                                   rgbs[i].astype(np.int64),
                                   float(errors[i]),
                                   tids[s:e].copy(), tidx[s:e].copy())
    return pts


def read_model_native(path: str):
    """(cameras, images, points3D) of a binary sparse directory."""
    return (read_cameras_native(os.path.join(path, "cameras.bin")),
            read_images_native(os.path.join(path, "images.bin")),
            read_points3d_native(os.path.join(path, "points3D.bin")))
