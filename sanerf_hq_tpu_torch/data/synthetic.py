"""Tiny analytic synthetic scene: a matte colour-by-normal sphere at the
origin rendered by exact ray-sphere intersection (numpy, no data needed),
and its object masks in the decode output format."""
from __future__ import annotations

import numpy as np


def look_at_pose(eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """OpenGL cam2world pose (camera looks along -z)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = x
    pose[:3, 1] = y
    pose[:3, 2] = z
    pose[:3, 3] = eye
    return pose


def _sphere_hits(pose, intrinsics, H, W, radius):
    """Per-pixel ray-sphere intersection: (hit [H, W] bool, first hit
    point [H, W, 3])."""
    fx, fy, cx, cy = intrinsics
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs = (xx + 0.5 - cx) / fx
    ys = -(yy + 0.5 - cy) / fy
    zs = -np.ones_like(xs)
    dirs = np.stack([xs, ys, zs], -1)
    dirs = dirs @ pose[:3, :3].T
    dn = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = pose[:3, 3]

    b = 2 * np.sum(dn * o, -1)
    c = np.sum(o * o) - radius * radius
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, 0.0)
    hit = hit & (t > 0)
    return hit, o + dn * t[..., None]


def render_gt_sphere(pose, intrinsics, H, W, radius=0.5):
    """Ground-truth image of a matte colour-by-normal sphere; white bg."""
    hit, p = _sphere_hits(pose, intrinsics, H, W, radius)
    normal = p / radius
    color = 0.5 * normal + 0.5
    return np.where(hit[..., None], color, 1.0).astype(np.float32)


def make_synthetic_dataset(n_views=12, H=64, W=64, fovy_deg=50.0, radius=2.0,
                           elevation=0.4):
    """Returns dict of numpy arrays: images [V,H,W,3], poses [V,4,4],
    intrinsics [4]."""
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(fovy_deg))
    intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
    images, poses = [], []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        eye = np.array(
            [radius * np.cos(theta), elevation, radius * np.sin(theta)],
            np.float32,
        )
        pose = look_at_pose(eye)
        poses.append(pose)
        images.append(render_gt_sphere(pose, intrinsics, H, W))
    return {
        "images": np.stack(images),
        "poses": np.stack(poses),
        "intrinsics": intrinsics,
        "H": H,
        "W": W,
    }


def write_llff_scene(root: str, n_views: int = 8, H: int = 64, W: int = 64):
    """Write the synthetic sphere as an llff-format scene on disk:
    images/vNN.png plus transforms.json.  Returns the dataset dict."""
    import json
    import os

    from .png import write_png

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    s = make_synthetic_dataset(n_views=n_views, H=H, W=W)
    frames = []
    for i in range(n_views):
        name = f"images/v{i:02d}.png"
        write_png(os.path.join(root, name),
                  (s["images"][i] * 255).astype(np.uint8))
        frames.append({"file_path": name,
                       "transform_matrix": s["poses"][i].tolist()})
    fx, fy, cx, cy = s["intrinsics"]
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"w": W, "h": H, "fl_x": float(fx), "fl_y": float(fy),
                   "cx": float(cx), "cy": float(cy), "frames": frames}, f)
    return s


def write_sphere_masks(root: str, n_views: int = 8, H: int = 64,
                       W: int = 64, radius: float = 0.5):
    """Object masks of the scene write_llff_scene writes with the same
    n_views, H and W, in the decode output format: {stem}_obj_mask.npy
    ([1, H, W] uint8, 1 on the sphere, 0 elsewhere) and valid_dict.json
    (every view valid, score 1)."""
    import json
    import os

    os.makedirs(root, exist_ok=True)
    s = make_synthetic_dataset(n_views=n_views, H=H, W=W)
    valid = {}
    for i in range(n_views):
        hit, _ = _sphere_hits(s["poses"][i], s["intrinsics"], H, W, radius)
        np.save(os.path.join(root, f"v{i:02d}_obj_mask.npy"),
                hit[None].astype(np.uint8))
        valid[f"v{i:02d}"] = 1.0
    with open(os.path.join(root, "valid_dict.json"), "w") as f:
        json.dump(valid, f)
