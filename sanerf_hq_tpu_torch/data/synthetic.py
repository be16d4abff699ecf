"""Tiny analytic synthetic scene: a matte colour-by-normal sphere at the
origin rendered by exact ray-sphere intersection (numpy, no data needed),
written as an llff scene (`write_llff_scene`) or in the Mip-NeRF 360
COLMAP layout (`write_colmap_scene`), its object masks in the decode
output format (`write_sphere_masks`), and the decode's 3-D point prompts
on its surface (`write_sphere_points`)."""
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


def synthetic_cameras(n_views=12, H=64, W=64, fovy_deg=50.0, radius=2.0,
                      elevation=0.4):
    """The views of the synthetic scene: a ring of cameras looking at the
    origin.  Returns (poses [V, 4, 4] OpenGL cam2world, intrinsics [4])."""
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(fovy_deg))
    intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
    poses = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        eye = np.array(
            [radius * np.cos(theta), elevation, radius * np.sin(theta)],
            np.float32,
        )
        poses.append(look_at_pose(eye))
    return np.stack(poses), intrinsics


def make_synthetic_dataset(n_views=12, H=64, W=64, fovy_deg=50.0, radius=2.0,
                           elevation=0.4):
    """Returns dict of numpy arrays: images [V,H,W,3], poses [V,4,4],
    intrinsics [4]."""
    poses, intrinsics = synthetic_cameras(n_views, H, W, fovy_deg, radius,
                                          elevation)
    images = [render_gt_sphere(p, intrinsics, H, W) for p in poses]
    return {
        "images": np.stack(images),
        "poses": poses,
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


def write_colmap_scene(root: str, n_views: int = 17, H: int = 64,
                       W: int = 64, downscale: int = 1, n_points: int = 2000,
                       seed: int = 0, radius: float = 0.5):
    """Write the synthetic sphere in the Mip-NeRF 360 layout: images/vNN.png
    at the camera's full size (H * downscale x W * downscale) and, for
    downscale > 1, images_{downscale}/vNN.png at H x W, each rendered
    exactly at its size; a COLMAP binary model in sparse/0: one PINHOLE
    camera at the full size (cameras.bin), each view's world-to-camera
    pose in OpenCV's axes with its observations of the sphere-surface
    points it sees inside the frame (images.bin), and n_points points drawn
    on the sphere from `seed` with their tracks (points3D.bin).  The views
    are those of write_sphere_masks(..., n_views, H * downscale,
    W * downscale).  Returns (poses [V, 4, 4] OpenGL cam2world, full-size
    intrinsics [4])."""
    import os
    import struct

    from .colmap import rotmat2qvec
    from .png import write_png

    Hf, Wf = H * downscale, W * downscale
    poses, intr = synthetic_cameras(n_views, Hf, Wf)
    fx, fy, cx, cy = (float(v) for v in intr)
    folders = [("images", Hf, Wf, intr)]
    if downscale > 1:
        folders.append((f"images_{downscale}", H, W, intr / downscale))
    for folder, h, w, k in folders:
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        for i, pose in enumerate(poses):
            img = render_gt_sphere(pose, k, h, w)
            write_png(os.path.join(root, folder, f"v{i:02d}.png"),
                      np.round(img * 255).astype(np.uint8))

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_points, 3))
    pts = radius * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, Wf, Hf))  # PINHOLE
        f.write(struct.pack("<4d", fx, fy, cx, cy))
    tracks = [[] for _ in range(n_points)]
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_views))
        for i, pose in enumerate(poses):
            o, R = pose[:3, 3].astype(np.float64), pose[:3, :3]
            cam = (pts - o) @ R  # OpenGL camera coordinates, looking at -z
            u = cx + fx * cam[:, 0] / -cam[:, 2]
            v = cy - fy * cam[:, 1] / -cam[:, 2]
            facing = np.sum(pts * (o - pts), axis=-1) > 0
            seen = np.flatnonzero(facing & (cam[:, 2] < 0) & (u >= 0)
                                  & (u < Wf) & (v >= 0) & (v < Hf))
            c2w = pose.astype(np.float64)
            c2w[:3, 1:3] *= -1  # OpenGL -> OpenCV axes
            w2c = np.linalg.inv(c2w)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *rotmat2qvec(w2c[:3, :3])))
            f.write(struct.pack("<3d", *w2c[:3, 3]))
            f.write(struct.pack("<i", 1))
            f.write(f"v{i:02d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", len(seen)))
            for j, p in enumerate(seen):
                f.write(struct.pack("<ddq", u[p], v[p], int(p) + 1))
                tracks[p].append((i + 1, j))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for p in range(n_points):
            f.write(struct.pack("<Q", p + 1))
            f.write(struct.pack("<3d", *pts[p]))
            rgb = np.round((0.5 * pts[p] / radius + 0.5) * 255)
            f.write(struct.pack("<3B", *rgb.astype(np.uint8)))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", len(tracks[p])))
            for image_id, idx in tracks[p]:
                f.write(struct.pack("<ii", image_id, idx))
    return poses, intr


def write_sphere_masks(root: str, n_views: int = 8, H: int = 64,
                       W: int = 64, radius: float = 0.5):
    """Object masks of the scene write_llff_scene writes with the same
    n_views, H and W (or write_colmap_scene at a full size of H x W), in
    the decode output format: {stem}_obj_mask.npy ([1, H, W] uint8, 1 on
    the sphere, 0 elsewhere) and valid_dict.json (every view valid, score
    1)."""
    import json
    import os

    os.makedirs(root, exist_ok=True)
    poses, intrinsics = synthetic_cameras(n_views, H, W)
    valid = {}
    for i in range(n_views):
        hit, _ = _sphere_hits(poses[i], intrinsics, H, W, radius)
        np.save(os.path.join(root, f"v{i:02d}_obj_mask.npy"),
                hit[None].astype(np.uint8))
        valid[f"v{i:02d}"] = 1.0
    with open(os.path.join(root, "valid_dict.json"), "w") as f:
        json.dump(valid, f)


def write_sphere_points(path: str, pts3d: np.ndarray, poses: np.ndarray):
    """The decode's point prompts for a scene whose sparse points pts3d
    [P, 3] lie on the sphere (write_colmap_scene's, in the loaded scene's
    frame): for each view of poses [V, 4, 4] (cam2world), the sparse point
    nearest its camera, i.e. on the front surface at the middle of the
    view.  Written in the schema of example_points.json that
    utils/points.load_point_file reads: every point positive, none
    crucial, and a view valid when one point passes the depth gate.
    Returns the points [K, 3] (K <= V, repeats dropped)."""
    import json

    d = np.linalg.norm(pts3d[None] - poses[:, None, :3, 3], axis=-1)
    idx = sorted(set(int(i) for i in d.argmin(1)))
    pts = np.asarray(pts3d, np.float64)[idx]
    with open(path, "w") as f:
        json.dump({"points": pts.tolist(), "negative_labels": [],
                   "crucial_point_index": [], "valid_threshold": 1}, f)
    return pts.astype(np.float32)
