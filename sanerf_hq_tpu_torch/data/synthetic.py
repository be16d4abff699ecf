"""Analytic synthetic scenes (numpy, no data needed).

The sphere scene: a matte colour-by-normal sphere at the origin rendered
by exact ray-sphere intersection, written as an llff scene
(`write_llff_scene`) or in the Mip-NeRF 360 COLMAP layout
(`write_colmap_scene`), its object masks in the decode output format
(`write_sphere_masks`), and the decode's 3-D point prompts on its surface
(`write_sphere_points`).

The quality scenes of the JAX package's `data/synthetic.py`, the same
arithmetic in the same dtypes: the rich scene (`render_rich_scene`,
`make_rich_dataset`: a checkered ground and three textured spheres with
object ids) and the clutter scene (`render_clutter_scene`,
`make_clutter_dataset`: seven objects with fine textures, occlusion and
extrapolated held-out views).  `tools/make_synth_scene.py` writes them to
disk."""
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


# ---------------------------------------------------------------------------
# Rich multi-object scene: textured ground + shaded spheres + box, object-id
# maps for stage-3 mIoU.  Still fully analytic (no data dependency), but
# with enough texture/parallax/occlusion to be a meaningful quality
# benchmark for the full 3-stage pipeline.
# ---------------------------------------------------------------------------

_SPHERES = [
    # (center, radius, base color, texture)
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


def render_rich_scene(pose, intrinsics, H, W):
    """Returns (img [H,W,3] float, obj_id [H,W] int: 0 bg, 1 plane,
    2..N spheres)."""
    fx, fy, cx, cy = intrinsics
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs = (xx + 0.5 - cx) / fx
    ys = -(yy + 0.5 - cy) / fy
    zs = -np.ones_like(xs)
    dirs = np.stack([xs, ys, zs], -1) @ pose[:3, :3].T
    dn = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = pose[:3, 3]

    t_best = np.full((H, W), np.inf, np.float32)
    obj_id = np.zeros((H, W), np.int32)
    img = np.zeros((H, W, 3), np.float32)

    # sky: direction-dependent gradient
    sky = (np.array([0.62, 0.72, 0.9], np.float32)[None, None]
           + 0.25 * np.clip(dn[..., 1:2], -1, 1))
    img[:] = sky

    # ground plane with checker texture (finite disk radius 4)
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
        albedo = base[None, None] * fac[..., None]
        t_best = np.where(m, ts, t_best)
        obj_id = np.where(m, k + 2, obj_id)
        img = np.where(m[..., None], _shade(albedo, normal), img)

    return np.clip(img, 0, 1).astype(np.float32), obj_id


# ---------------------------------------------------------------------------
# Clutter scene: the harder quality benchmark: 7 labeled
# objects (spheres, a box, a cylinder), high-frequency textures, strong
# inter-object occlusion, and an extrapolated-view val split (higher
# elevation + closer radius than any train view).
# ---------------------------------------------------------------------------

_CL_SPHERES = [
    # (center, radius, base color, texture)
    (np.array([0.0, -0.05, 0.0], np.float32), 0.45,
     np.array([0.85, 0.3, 0.25], np.float32), "stripes_fine"),
    (np.array([0.95, -0.35, -0.35], np.float32), 0.25,
     np.array([0.25, 0.5, 0.9], np.float32), "marble"),
    (np.array([-0.85, -0.32, 0.45], np.float32), 0.28,
     np.array([0.3, 0.8, 0.35], np.float32), "checker_fine"),
    # small sphere tucked behind the box from most ring views (occlusion)
    (np.array([0.45, -0.42, 0.95], np.float32), 0.18,
     np.array([0.95, 0.8, 0.2], np.float32), "stripes_fine"),
]
_CL_BOX = (np.array([0.35, -0.6, 0.65], np.float32),   # min corner
           np.array([0.95, -0.05, 1.15], np.float32))  # max corner
_CL_CYL = (np.array([-0.55, 0.0, -0.85], np.float32), 0.2, -0.6, 0.35)
# (xz center in x/z components, radius, y_min, y_max)


def _box_hit(o, dn, bmin, bmax):
    """Slab-method ray-AABB; returns (t, axis-normal) with t=inf on miss."""
    inv = 1.0 / np.where(np.abs(dn) < 1e-9, 1e-9, dn)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tmin = np.minimum(t0, t1)
    tmax = np.maximum(t0, t1)
    t_near = tmin.max(-1)
    t_far = tmax.min(-1)
    hit = (t_near <= t_far) & (t_far > 1e-4)
    t = np.where(t_near > 1e-4, t_near, t_far)
    t = np.where(hit, t, np.inf)
    axis = tmin.argmax(-1)  # the slab that sets t_near
    return t, axis


def _cyl_hit(o, dn, center, radius, y0, y1):
    """Finite open vertical cylinder |p.xz - c.xz| = r, y in [y0, y1]."""
    ox, oz = o[0] - center[0], o[2] - center[2]
    dx, dz = dn[..., 0], dn[..., 2]
    a = dx * dx + dz * dz
    b = 2 * (ox * dx + oz * dz)
    c = ox * ox + oz * oz - radius * radius
    disc = b * b - 4 * a * c
    ok = (disc > 0) & (a > 1e-9)
    sq = np.sqrt(np.maximum(disc, 0))
    t = np.where(ok, (-b - sq) / np.where(a > 1e-9, 2 * a, 1.0), np.inf)
    y = o[1] + dn[..., 1] * t
    t = np.where(ok & (t > 1e-4) & (y >= y0) & (y <= y1), t, np.inf)
    return t


def render_clutter_scene(pose, intrinsics, H, W):
    """Returns (img [H,W,3], obj_id [H,W]: 0 sky, 1 ground, 2..5 spheres,
    6 box, 7 cylinder)."""
    fx, fy, cx, cy = intrinsics
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs = (xx + 0.5 - cx) / fx
    ys = -(yy + 0.5 - cy) / fy
    dirs = np.stack([xs, ys, -np.ones_like(xs)], -1) @ pose[:3, :3].T
    dn = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = pose[:3, 3]

    t_best = np.full((H, W), np.inf, np.float32)
    obj_id = np.zeros((H, W), np.int32)
    img = (np.array([0.6, 0.7, 0.88], np.float32)[None, None]
           + 0.25 * np.clip(dn[..., 1:2], -1, 1)
           + 0.05 * np.sin(6.0 * dn[..., 0:1]))  # banded sky

    # ground: fine checker * radial rings
    denom = dn[..., 1]
    tp = (_PLANE_Y - o[1]) / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
    p = o + dn * tp[..., None]
    r2 = p[..., 0] ** 2 + p[..., 2] ** 2
    in_disk = (tp > 1e-4) & (r2 < 16.0)
    checker = ((np.floor(p[..., 0] * 6.0) + np.floor(p[..., 2] * 6.0)) % 2)
    rings = 0.5 + 0.5 * np.sin(6.0 * np.sqrt(np.maximum(r2, 1e-9)))
    base = (0.2 + 0.45 * checker + 0.2 * rings)[..., None] * np.array(
        [1.0, 0.93, 0.8], np.float32)
    m = in_disk & (tp < t_best)
    t_best = np.where(m, tp, t_best)
    obj_id = np.where(m, 1, obj_id)
    img = np.where(m[..., None],
                   _shade(base, np.array([0, 1, 0], np.float32)), img)

    for k, (center, radius, col, tex) in enumerate(_CL_SPHERES):
        ts = _sphere_hit(o, dn, center, radius)
        m = ts < t_best
        if not m.any():
            continue
        p = o + dn * np.where(np.isfinite(ts), ts, 0.0)[..., None]
        normal = (p - center) / radius
        if tex == "stripes_fine":
            fac = 0.55 + 0.45 * np.sign(np.sin(p[..., 1] * 40.0))
        elif tex == "checker_fine":
            fac = 0.55 + 0.45 * ((np.floor(p[..., 0] * 16)
                                  + np.floor(p[..., 2] * 16)) % 2)
        else:  # marble
            fac = 0.6 + 0.4 * np.sin(10.0 * p[..., 0]
                                     + 4.0 * np.sin(3.0 * p[..., 2]))
        albedo = col[None, None] * fac[..., None]
        t_best = np.where(m, ts, t_best)
        obj_id = np.where(m, k + 2, obj_id)
        img = np.where(m[..., None], _shade(albedo, normal), img)

    # box (object 6): per-axis face colors + diagonal stripes
    tb, axis = _box_hit(o, dn, *_CL_BOX)
    m = tb < t_best
    if m.any():
        p = o + dn * np.where(np.isfinite(tb), tb, 0.0)[..., None]
        stripes = 0.6 + 0.4 * np.sign(
            np.sin(18.0 * (p[..., 0] + p[..., 1] + p[..., 2])))
        tint = (0.75 + 0.12 * axis)[..., None]  # per-face shade
        albedo = np.array([0.9, 0.45, 0.15], np.float32) * stripes[..., None] \
            * tint
        # slab normal: sign from ray direction
        normal = np.zeros_like(p)
        for a in range(3):
            sel = axis == a
            normal[..., a] = np.where(sel, -np.sign(dn[..., a]), 0.0)
        t_best = np.where(m, tb, t_best)
        obj_id = np.where(m, 6, obj_id)
        img = np.where(m[..., None], _shade(albedo, normal), img)

    # cylinder (object 7): helical stripes
    cc, cr, cy0, cy1 = _CL_CYL
    tc = _cyl_hit(o, dn, cc, cr, cy0, cy1)
    m = tc < t_best
    if m.any():
        p = o + dn * np.where(np.isfinite(tc), tc, 0.0)[..., None]
        theta = np.arctan2(p[..., 2] - cc[2], p[..., 0] - cc[0])
        helix = 0.55 + 0.45 * np.sign(np.sin(4.0 * theta + 14.0 * p[..., 1]))
        albedo = np.array([0.55, 0.25, 0.75], np.float32)[None, None] \
            * helix[..., None]
        normal = np.stack([p[..., 0] - cc[0], np.zeros_like(tc),
                           p[..., 2] - cc[2]], -1) / cr
        t_best = np.where(m, tc, t_best)
        obj_id = np.where(m, 7, obj_id)
        img = np.where(m[..., None], _shade(albedo, normal), img)

    return np.clip(img, 0, 1).astype(np.float32), obj_id


def make_clutter_dataset(n_views: int = 28, H: int = 240, W: int = 320,
                         fovy_deg: float = 55.0, radius: float = 2.7,
                         n_extrap: int = 4):
    """Train ring at elevations {0.5, 1.0} plus `n_extrap` EXTRAPOLATED
    val views (elevation 1.7, radius 0.75x — outside the train rig's
    envelope).  Returns the usual dataset dict + 'val_names': the view
    indices meant for a val_split test-view list (extrapolated views
    last, names v{i:03d})."""
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(fovy_deg))
    intr = np.array([focal, focal, W / 2, H / 2], np.float32)
    images, poses, ids = [], [], []

    def add(eye):
        pose = look_at_pose(eye, center=(0.0, -0.2, 0.0))
        img, oid = render_clutter_scene(pose, intr, H, W)
        images.append(img)
        poses.append(pose)
        ids.append(oid)

    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        r = radius * (0.85 if i % 6 == 0 else 1.0)
        elev = 0.5 if i % 2 == 0 else 1.0
        add(np.array([r * np.cos(theta), elev, r * np.sin(theta)],
                     np.float32))
    for j in range(n_extrap):
        theta = 2 * np.pi * (j + 0.37) / n_extrap
        r = radius * 0.75
        add(np.array([r * np.cos(theta), 1.7, r * np.sin(theta)],
                     np.float32))
    val_names = [f"v{n_views + j:03d}" for j in range(n_extrap)]
    return {"images": np.stack(images), "poses": np.stack(poses),
            "intrinsics": intr, "obj_ids": np.stack(ids), "H": H, "W": W,
            "val_names": val_names, "n_inst": 8}


def make_rich_dataset(n_views: int = 24, H: int = 240, W: int = 320,
                      fovy_deg: float = 55.0, radius: float = 2.6):
    """Orbit rig at two elevations + closer accent views; returns images,
    poses, intrinsics, obj_ids."""
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
        img, oid = render_rich_scene(pose, intr, H, W)
        images.append(img)
        poses.append(pose)
        ids.append(oid)
    return {"images": np.stack(images), "poses": np.stack(poses),
            "intrinsics": intr, "obj_ids": np.stack(ids), "H": H, "W": W}
