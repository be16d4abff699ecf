"""The benchmark's scene: the rich synthetic scene (a checkered ground
disc and three textured spheres with object ids, ray-traced in numpy),
written to disk as an llff scene with the decode's mask layout, so that
the program loads it through its own loader.

A frozen copy of the arithmetic of `make_rich_dataset` /
`render_rich_scene`; the benchmark keeps its own so that a change to the
program cannot change the inputs.  Writes `images/v{i:03d}.png`,
`transforms.json` and, for the object of id `mask_object`, the decode
output `masks/{stem}_obj_mask.npy` ([1, H, W] float32) with
`masks/valid_dict.json` (every view valid)."""
from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

_SPHERES = [
    (np.array([0.0, -0.1, 0.0], np.float32), 0.5,
     np.array([0.85, 0.3, 0.25], np.float32), "stripes"),
    (np.array([0.9, -0.35, -0.4], np.float32), 0.25,
     np.array([0.25, 0.5, 0.9], np.float32), "solid"),
    (np.array([-0.8, -0.3, 0.5], np.float32), 0.3,
     np.array([0.3, 0.8, 0.35], np.float32), "checker"),
]
_PLANE_Y = -0.6
_SUN = np.array([0.4, 0.8, 0.45], np.float32) / np.linalg.norm(
    [0.4, 0.8, 0.45])


def look_at_pose(eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """OpenGL cam2world pose (the camera looks along -z)."""
    eye = np.asarray(eye, np.float32)
    z = eye - np.asarray(center, np.float32)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float32), z)
    x = x / np.linalg.norm(x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = x, np.cross(z, x), z
    pose[:3, 3] = eye
    return pose


def _sphere_hit(o, dn, center, radius):
    oc = o - center
    b = 2 * np.sum(dn * oc, -1)
    c = np.sum(oc * oc, -1) - radius * radius
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
    return np.where(hit & (t > 1e-4), t, np.inf)


def _shade(albedo, normal):
    lam = np.clip(np.sum(normal * _SUN, -1, keepdims=True), 0, 1)
    return albedo * (0.35 + 0.65 * lam)


def render_rich(pose, intrinsics, H, W):
    """(image [H, W, 3] float32, object ids [H, W]: 0 sky, 1 ground, 2..4
    the spheres)."""
    fx, fy, cx, cy = intrinsics
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack([(xx + 0.5 - cx) / fx, -(yy + 0.5 - cy) / fy,
                     -np.ones((H, W))], -1) @ pose[:3, :3].T
    dn = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = pose[:3, 3]
    t_best = np.full((H, W), np.inf, np.float32)
    obj_id = np.zeros((H, W), np.int32)
    img = np.zeros((H, W, 3), np.float32)
    img[:] = (np.array([0.62, 0.72, 0.9], np.float32)[None, None]
              + 0.25 * np.clip(dn[..., 1:2], -1, 1))

    denom = dn[..., 1]
    tp = (_PLANE_Y - o[1]) / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
    p = o + dn * tp[..., None]
    in_disk = (tp > 1e-4) & (p[..., 0] ** 2 + p[..., 2] ** 2 < 16.0)
    checker = ((np.floor(p[..., 0] * 2.5) + np.floor(p[..., 2] * 2.5))
               % 2).astype(np.float32)
    plane_col = (0.25 + 0.5 * checker)[..., None] * np.array(
        [1.0, 0.95, 0.85], np.float32)
    m = in_disk & (tp < t_best)
    t_best = np.where(m, tp, t_best)
    obj_id = np.where(m, 1, obj_id)
    img = np.where(m[..., None], _shade(plane_col,
                                        np.array([0, 1, 0], np.float32)), img)

    for k, (center, radius, base, tex) in enumerate(_SPHERES):
        ts = _sphere_hit(o, dn, center, radius)
        m = ts < t_best
        if not m.any():
            continue
        p = o + dn * np.where(np.isfinite(ts), ts, 0.0)[..., None]
        normal = (p - center) / radius
        if tex == "stripes":
            fac = 0.55 + 0.45 * np.sign(np.sin(p[..., 1] * 18.0))
        elif tex == "checker":
            fac = 0.55 + 0.45 * ((np.floor(p[..., 0] * 8)
                                  + np.floor(p[..., 2] * 8)) % 2)
        else:
            fac = np.ones_like(ts)
        t_best = np.where(m, ts, t_best)
        obj_id = np.where(m, k + 2, obj_id)
        img = np.where(m[..., None],
                       _shade(base[None, None] * fac[..., None], normal), img)
    return np.clip(img, 0, 1).astype(np.float32), obj_id


def make_rich(n_views: int, H: int, W: int, fovy_deg: float = 55.0,
              radius: float = 2.6):
    """An orbit at two elevations with closer accent views."""
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(fovy_deg))
    intr = np.array([focal, focal, W / 2, H / 2], np.float32)
    images, poses, ids = [], [], []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        r = radius * (0.82 if i % 5 == 0 else 1.0)
        elev = 0.55 if i % 2 == 0 else 1.1
        eye = np.array([r * np.cos(theta), elev, r * np.sin(theta)],
                       np.float32)
        pose = look_at_pose(eye, center=(0.0, -0.2, 0.0))
        img, oid = render_rich(pose, intr, H, W)
        images.append(img)
        poses.append(pose)
        ids.append(oid)
    return {"images": np.stack(images), "poses": np.stack(poses),
            "intrinsics": intr, "obj_ids": np.stack(ids)}


def _png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, every row unfiltered."""
    H, W, C = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          img.reshape(H, W * C)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_scene(root: str, spec: dict) -> dict:
    """Write the scene of a configuration's `scene` entry under root and
    return what the reference reads: uint8 images [V, H, W, 3], the
    generator's poses [V, 4, 4], intrinsics [4], object ids [V, H, W]."""
    if spec["kind"] != "rich":
        raise ValueError(f"unknown scene {spec['kind']!r}")
    d = make_rich(spec["n_views"], spec["H"], spec["W"])
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    u8 = (d["images"] * 255).astype(np.uint8)
    frames, valid = [], {}
    for i in range(u8.shape[0]):
        stem = f"v{i:03d}"
        with open(os.path.join(root, "images", stem + ".png"), "wb") as f:
            f.write(_png(u8[i]))
        frames.append({"file_path": f"images/{stem}.png",
                       "transform_matrix": d["poses"][i].tolist()})
        mask = (d["obj_ids"][i] == spec["mask_object"]).astype(np.float32)
        np.save(os.path.join(root, "masks", f"{stem}_obj_mask.npy"),
                mask[None])
        valid[stem] = 1.0
    fx, fy, cx, cy = (float(v) for v in d["intrinsics"])
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"w": spec["W"], "h": spec["H"], "fl_x": fx, "fl_y": fy,
                   "cx": cx, "cy": cy, "frames": frames}, f)
    with open(os.path.join(root, "masks", "valid_dict.json"), "w") as f:
        json.dump(valid, f)
    return {"images": u8, "poses": d["poses"], "intrinsics": d["intrinsics"],
            "obj_ids": d["obj_ids"]}


def llff_poses(poses: np.ndarray, scale: float = 0.33) -> np.ndarray:
    """The poses in the frame an llff loader works in: rows permuted
    (y, z, x), translations scaled by 0.33."""
    out = poses[:, [1, 2, 0, 3], :].copy()
    out[:, 3] = np.array([0, 0, 0, 1], np.float32)
    out[:, :3, 3] *= scale
    return out.astype(np.float32)
