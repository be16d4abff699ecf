"""COLMAP sparse-model readers (binary and text), pure Python.

The public COLMAP format (https://colmap.github.io/format.html), as the
JAX package's `data/colmap.py` reads it: the camera-model table,
`qvec2rotmat` / `rotmat2qvec`, the binary readers of cameras, images and
points3D, the text readers of cameras and images, and `load_sparse_model`
(binary when `cameras.bin` exists, else text, which returns no points).
A binary model goes through the native C++ reader (data/colmap_native.py)
whenever a C++ compiler is on the PATH; its build or read failing raises.
The Python readers take it only when there is no compiler, and say so.
(The JAX package swallows the native reader's failures and falls back.)
"""
from __future__ import annotations

import collections
import os
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple("CameraModel",
                                     ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
MODEL_BY_ID = {m.model_id: m for m in CAMERA_MODELS}
MODEL_BY_NAME = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """Quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R):
    """Rotation matrix -> quaternion (w, x, y, z) with w >= 0."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1],
         0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(fh, fmt):
    return struct.unpack(fmt, fh.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            model = MODEL_BY_ID[model_id]
            params = np.array(_read(fh, f"<{model.num_params}d"))
            cams[cam_id] = Camera(cam_id, model.model_name, width, height,
                                  params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            img_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            cam_id = _read(fh, "<i")[0]
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(fh, "<Q")
            # each observation: x, y (float64) and a point3D id (int64)
            data = np.frombuffer(fh.read(24 * n2d),
                                 dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            p3d_ids = data[:, 2].view(np.int64).copy()
            images[img_id] = Image(img_id, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys, p3d_ids)
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            p_id = _read(fh, "<Q")[0]
            xyz = np.array(_read(fh, "<3d"))
            rgb = np.array(_read(fh, "<3B"))
            (error,) = _read(fh, "<d")
            (tl,) = _read(fh, "<Q")
            track = np.frombuffer(fh.read(8 * tl),
                                  dtype=np.int32).reshape(-1, 2)
            pts[p_id] = Point3D(p_id, xyz, rgb, error, track[:, 0].copy(),
                                track[:, 1].copy())
    return pts


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            params = np.array([float(p) for p in parts[4:]])
            cams[cam_id] = Camera(cam_id, parts[1], int(parts[2]),
                                  int(parts[3]), params)
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    """Two lines an image: its pose and name, then (x, y, point3D id)
    triples.  Blank lines are dropped before pairing, as the JAX reader
    does."""
    images = {}
    with open(path) as fh:
        lines = [l.strip() for l in fh if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = (np.array([float(e) for e in elems]).reshape(-1, 3) if elems
               else np.zeros((0, 3)))
        images[img_id] = Image(img_id, qvec, tvec, int(parts[8]), parts[9],
                               xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def load_sparse_model(path: str):
    """(cameras, images, points3D) of a COLMAP sparse directory: the
    binary model when `cameras.bin` exists (the native reader where a C++
    compiler is on the PATH), else the text model (cameras and images; no
    points)."""
    if os.path.exists(os.path.join(path, "cameras.bin")):
        from .colmap_native import compiler, read_model_native

        if compiler() is not None:
            return read_model_native(path)
        print("[INFO] no C++ compiler on the PATH: the COLMAP model is read "
              "by the Python readers", flush=True)
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3d_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")), {})
