"""Scene loading, host-side (numpy): the four dataset families, the
reference split logic, and the stage-3 object masks (`load_object_masks`),
with OpenCV's three resizes in numpy (`resize_area`, `resize_nearest`,
`resize_linear`: INTER_AREA, INTER_NEAREST and, on float images,
INTER_LINEAR), so that no scene needs OpenCV but one in JPEG.

  - 'llff' / '3dfront': transforms.json with fl_x/fl_y/cx/cy + frames; ngp
    axis permutation then y/z column flips; 3dfront recentres
    (center_poses) and auto-scales;
  - 'others': images_{k}/ with metadata.json (K scaled by W and H,
    positions and (w, x, y, z) quaternions) or a pose/ folder and
    intrinsic/intrinsic_color.txt;
  - 'mip' / 'lerf': a COLMAP sparse model (data/colmap.py) with the
    convention rectification (column flip, rows [1, 0, 2], row-2
    negation), the auto-scale and the per-view near/far of the sparse
    points each view sees.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from .colmap import load_sparse_model, qvec2rotmat
from .png import read_png


@dataclasses.dataclass
class Scene:
    images: Optional[np.ndarray]  # [V, H, W, 3/4] float32 in [0,1] (None for test-only)
    poses: np.ndarray  # [V, 4, 4] cam2world, ngp convention
    intrinsics: np.ndarray  # [V, 4] (fx, fy, cx, cy)
    H: int
    W: int
    img_names: np.ndarray  # [V] str
    cam_near_far: Optional[np.ndarray] = None  # [V, 2]
    masks: Optional[np.ndarray] = None  # [V, H, W] int labels (-1 = unlabeled)
    pts_aabb: Optional[np.ndarray] = None  # [6]
    scale: float = 1.0
    transforms: Optional[dict] = None  # center/R used by center_poses
    pts3d: Optional[np.ndarray] = None  # [P, 3] sparse points


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-10)


def rotmat_between(a, b):
    a, b = _normalize(np.asarray(a, np.float64)), _normalize(np.asarray(b, np.float64))
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-10:
        return rotmat_between(a + np.random.uniform(-1e-2, 1e-2, 3), b)
    s = np.linalg.norm(v)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s ** 2 + 1e-10))


def center_poses(poses, pts3d=None, enable_cam_center=False):
    """Recenter on the camera/point cloud and align mean-up with +z."""
    if pts3d is None or enable_cam_center:
        center = poses[:, :3, 3].mean(0)
    else:
        center = pts3d.mean(0)
    up = _normalize(poses[:, :3, 1].mean(0))
    R = rotmat_between(up, [0, 0, 1])
    R4 = np.eye(4)
    R4[:3, :3] = R
    poses = poses.copy()
    poses[:, :3, 3] -= center
    poses_centered = (R4 @ poses).astype(np.float32)
    transforms = {"center": center, "R": R4}
    if pts3d is not None:
        pts3d_centered = (pts3d - center) @ R.T
        return poses_centered, pts3d_centered, transforms
    return poses_centered, None, transforms


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """Axis permutation (y,z,x) with translation scale/offset."""
    return np.array([
        [pose[1, 0], pose[1, 1], pose[1, 2], pose[1, 3] * scale + offset[0]],
        [pose[2, 0], pose[2, 1], pose[2, 2], pose[2, 3] * scale + offset[1]],
        [pose[0, 0], pose[0, 1], pose[0, 2], pose[0, 3] * scale + offset[2]],
        [0, 0, 0, 1],
    ], dtype=np.float32)


def _load_image(path: str) -> np.ndarray:
    """RGB(A) float32 in [0, 1].  PNGs are read here; other formats (the
    Mip-NeRF 360 JPEGs) need OpenCV's decoder."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.shape[-1] in (1, 2):  # grey (+ alpha)
            img = np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]],
                                 axis=-1)
    else:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"{path}: decoding {os.path.splitext(path)[1] or 'this'} "
                "images needs OpenCV (cv2), which is not installed; only "
                "PNG is read without it") from e

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        code = cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4 else cv2.COLOR_BGR2RGB
        img = cv2.cvtColor(img, code)
    return img.astype(np.float32) / 255.0


def _find_img_folder(root: str, downscale: int) -> str:
    folder = os.path.join(root, f"images_{downscale}")
    if not os.path.exists(folder):
        folder = os.path.join(root, "images")
    return folder


def load_scene(root_path: str, data_type: str = "mip", downscale: int = 1,
               scale: float = -1.0, offset=(0, 0, 0),
               enable_cam_center: bool = False, bound: float = 128.0,
               load_images: bool = True) -> Scene:
    if data_type in ("llff", "3dfront"):
        return _load_transforms_json(root_path, data_type, downscale, scale,
                                     offset, enable_cam_center, load_images)
    if data_type == "others":
        return _load_others(root_path, downscale, scale, enable_cam_center,
                            load_images)
    if data_type in ("mip", "lerf"):
        return _load_colmap(root_path, downscale, scale, enable_cam_center,
                            load_images)
    raise NotImplementedError(f"Unsupported data type: {data_type}")


def _load_transforms_json(root, data_type, downscale, scale, offset,
                          enable_cam_center, load_images):
    with open(os.path.join(root, "transforms.json")) as f:
        transform = json.load(f)
    H, W = int(transform["h"]), int(transform["w"])

    # 3D-FRONT: center offset from the ground-truth room bbox
    if data_type == "3dfront" and "room_bbox" in transform:
        bbox = np.array(transform["room_bbox"])
        s = scale if scale != -1 else 1.0
        offset = tuple(-(bbox[0] + bbox[1]) * 0.5 * s)

    img_folder = _find_img_folder(root, downscale)
    img_paths, poses, intrinsics = [], [], []
    intr = np.array([transform["fl_x"], transform["fl_y"], transform["cx"],
                     transform["cy"]], dtype=np.float32)
    for frame in transform["frames"]:
        p = frame["file_path"]
        cand = os.path.join(root, p)
        if not os.path.exists(cand):
            cand = os.path.join(img_folder, os.path.basename(p))
        img_paths.append(cand)
        pose = nerf_matrix_to_ngp(
            np.array(frame["transform_matrix"], dtype=np.float32), scale=1
        )
        pose[:, 1:3] = -pose[:, 1:3]
        poses.append(pose)
        intrinsics.append(intr)
    poses = np.stack(poses)
    poses[:, :3, 1:3] *= -1  # camera looks at -z
    intrinsics = np.stack(intrinsics)

    if data_type == "llff":
        # the reference multiplies intrinsics/H/W by downscale
        intrinsics = intrinsics * downscale
        H, W = H * downscale, W * downscale
        pts3d = poses[:, :3, 3]
        if scale == -1:
            scale = 0.33
        poses[:, :3, 3] *= scale
        transforms = None
    else:  # 3dfront
        pts3d = poses[:, :3, 3].copy()
        poses, pts3d, transforms = center_poses(poses, pts3d, enable_cam_center)
        if scale == -1:
            scale = 1 / max(np.linalg.norm(poses[:, :3, 3], axis=-1).max(), 1e-8)
        poses[:, :3, 3] *= scale
        pts3d = pts3d * scale

    pts_aabb = np.concatenate([pts3d.min(0), pts3d.max(0)])
    img_names = np.array([os.path.basename(p) for p in img_paths])
    images = _stack_images(img_paths, H, W) if load_images else None
    return Scene(images, poses.astype(np.float32), intrinsics, H, W,
                 img_names, None, None, pts_aabb, scale, transforms)


def _load_others(root, downscale, scale, enable_cam_center, load_images):
    img_folder = _find_img_folder(root, downscale)
    img_names = sorted(os.listdir(img_folder))
    img_paths = [os.path.join(img_folder, n) for n in img_names]
    H, W = _load_image(img_paths[0]).shape[:2]

    poses, intrinsics = [], []
    meta_path = os.path.join(root, "metadata.json")
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        K = np.array(meta["camera"]["K"])
        K[0] *= W
        K[1] *= H
        intr = np.abs(np.array([K[0, 0], K[1, 1], K[0, -1], K[1, -1]],
                               dtype=np.float32))
        for t, q in zip(meta["camera"]["positions"],
                        meta["camera"]["quaternions"]):
            pose = np.eye(4)
            pose[:3, :3] = qvec2rotmat(np.array(q))  # (w, x, y, z)
            pose[:3, 3] = np.array(t)
            poses.append(pose)
            intrinsics.append(intr)
    else:
        M = np.loadtxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"),
                       ndmin=2)
        intr = np.array([M[0, 0], M[1, 1], M[0, -2], M[1, -2]],
                        dtype=np.float32)
        for name in img_names:
            pose = np.loadtxt(os.path.join(root, "pose", name[:-3] + "txt"),
                              ndmin=2)
            pose[:, 1:3] = -pose[:, 1:3]
            poses.append(pose)
            intrinsics.append(intr)

    poses = np.stack(poses).astype(np.float64)
    poses, _, transforms = center_poses(poses, poses[:, :3, 3].copy(),
                                        enable_cam_center)
    if scale == -1:
        scale = 1 / max(np.linalg.norm(poses[:, :3, 3], axis=-1).max(), 1e-8)
    poses[:, :3, 3] *= scale
    pts_aabb = np.concatenate([poses[:, :3, 3].min(0), poses[:, :3, 3].max(0)])
    images = _stack_images(img_paths, H, W) if load_images else None
    return Scene(images, poses.astype(np.float32), np.stack(intrinsics), H, W,
                 np.array(img_names), None, None, pts_aabb, scale, transforms)


def _load_colmap(root, downscale, scale, enable_cam_center, load_images):
    colmap_path = next((os.path.join(root, c) for c in
                        ("colmap_sparse/0", "sparse/0", "colmap")
                        if os.path.exists(os.path.join(root, c))), None)
    if colmap_path is None:
        raise ValueError(f"Cannot find colmap sparse output under {root}")
    camdata, imdata, ptsdata = load_sparse_model(colmap_path)

    first_cam = camdata[sorted(camdata.keys())[0]]
    H = int(round(first_cam.height / downscale))
    W = int(round(first_cam.width / downscale))

    imkeys = np.array(sorted(imdata.keys()))
    img_names = np.array([os.path.basename(imdata[k].name) for k in imkeys])
    img_folder = _find_img_folder(root, downscale)
    img_paths = np.array([os.path.join(img_folder, n) for n in img_names])
    exist = np.array([os.path.exists(f) for f in img_paths])
    imkeys, img_names, img_paths = imkeys[exist], img_names[exist], \
        img_paths[exist]

    intrinsics = []
    for k in imkeys:
        cam = camdata[imdata[k].camera_id]
        if cam.model in ("SIMPLE_RADIAL", "SIMPLE_PINHOLE"):
            fl_x = fl_y = cam.params[0] / downscale
            cx, cy = cam.params[1] / downscale, cam.params[2] / downscale
        elif cam.model in ("PINHOLE", "OPENCV"):
            fl_x, fl_y = cam.params[0] / downscale, cam.params[1] / downscale
            cx, cy = cam.params[2] / downscale, cam.params[3] / downscale
        else:
            raise ValueError(f"Unsupported colmap camera model: {cam.model}")
        intrinsics.append(np.array([fl_x, fl_y, cx, cy], dtype=np.float32))
    intrinsics = np.stack(intrinsics)

    w2c = np.tile(np.eye(4), (len(imkeys), 1, 1))
    for i, k in enumerate(imkeys):
        w2c[i, :3, :3] = qvec2rotmat(imdata[k].qvec)
        w2c[i, :3, 3] = imdata[k].tvec
    poses = np.linalg.inv(w2c)  # cam2world

    ptskeys = (np.array(sorted(ptsdata.keys())) if ptsdata
               else np.array([], np.int64))
    pts3d = (np.array([ptsdata[k].xyz for k in ptskeys]) if len(ptskeys)
             else poses[:, :3, 3].copy())
    poses, pts3d, transforms = center_poses(poses, pts3d, enable_cam_center)

    # convention rectification
    poses[:, :3, 1:3] *= -1
    poses = poses[:, [1, 0, 2, 3], :]
    poses[:, 2] *= -1
    pts3d = pts3d[:, [1, 0, 2]]
    pts3d[:, 2] *= -1

    if scale == -1:
        scale = 1 / max(np.linalg.norm(poses[:, :3, 3], axis=-1).max(), 1e-8)
    poses[:, :3, 3] *= scale
    pts3d = pts3d * scale
    pts_aabb = np.concatenate([pts3d.min(0), pts3d.max(0)])
    cam_near_far = _sparse_depth_near_far(imdata, imkeys, ptsdata, ptskeys,
                                          poses, pts3d, camdata)
    images = _stack_images(list(img_paths), H, W) if load_images else None
    return Scene(images, poses.astype(np.float32), intrinsics, H, W,
                 img_names, cam_near_far, None, pts_aabb, scale, transforms,
                 pts3d=pts3d.astype(np.float32))


def _sparse_depth_near_far(imdata, imkeys, ptsdata, ptskeys, poses, pts3d,
                           camdata=None):
    """Per-view [near, far]: the least and greatest depth, along the
    rectified camera's z column, of the sparse points the view observes
    (point3D id != -1, keypoint inside the original-resolution frame).
    Point ids are clipped into the key table; a view with no such point
    gets [0.05, 1e3].  None when the model has no points."""
    if not len(ptskeys):
        return None
    key_to_id = np.full(int(ptskeys.max()) + 2, -1, dtype=np.int64)
    key_to_id[ptskeys] = np.arange(len(ptskeys))
    out = []
    for i, k in enumerate(imkeys):
        im = imdata[k]
        pids = np.asarray(im.point3D_ids)
        mask = pids != -1
        xys = np.asarray(im.xys, np.float64)
        if camdata is not None and xys.shape[0] == pids.shape[0]:
            cam = camdata[im.camera_id]
            mask &= ((xys[:, 0] >= 0) & (xys[:, 0] < cam.width)
                     & (xys[:, 1] >= 0) & (xys[:, 1] < cam.height))
        ids = key_to_id[np.clip(pids[mask], 0, len(key_to_id) - 1)]
        ids = ids[ids >= 0]
        if ids.size == 0:
            out.append(np.array([0.05, 1e3], np.float32))
            continue
        depth = (poses[i, :3, 3] - pts3d[ids]) @ poses[i, :3, 2]
        out.append(np.array([depth.min(), depth.max()], np.float32))
    return np.stack(out)


def _stack_images(paths, H, W):
    imgs = []
    for p in paths:
        img = _load_image(p)
        if img.shape[0] != H or img.shape[1] != W:
            img = resize_area(img, H, W)
        imgs.append(img)
    return np.stack(imgs)


def split_indices(n_views: int, split: str, val_type: str = "default",
                  test_view_names=None, img_names=None,
                  auto_seg: bool = False):
    """Reference split logic: val 'default' holds out every 16th view and
    train is everything else; 'val_all' puts every view in val (train
    empty); 'val_split' selects val views whose image-name stem appears in
    the test-view list (falling back to ::16 without one).  auto_seg: val =
    the first 100 views, train = all views."""
    all_idx = np.arange(n_views)
    if auto_seg:
        if split in ("train", "all", "trainval"):
            return all_idx
        return all_idx[:100]
    if val_type == "val_all":
        return all_idx if split != "train" else all_idx[:0]
    if val_type == "val_split" and test_view_names is not None and img_names is not None:
        test_set = {os.path.splitext(n)[0] for n in test_view_names}
        is_test = np.array(
            [os.path.splitext(str(n))[0] in test_set for n in img_names])
        if split in ("train", "all", "trainval"):
            return all_idx[~is_test]
        return all_idx[is_test]
    if split in ("train",):
        return all_idx[all_idx % 16 != 0]
    if split in ("val", "test"):
        return all_idx[all_idx % 16 == 0]
    return all_idx  # 'all' / 'trainval'


def _area_weights(dst: int, src: int) -> np.ndarray:
    """OpenCV's INTER_AREA weights along a shrinking axis, [dst, src]: each
    output cell's overlap with the source pixels over its width
    (computeResizeAreaTab, the weights rounded to float32)."""
    A = np.zeros((dst, src), np.float64)
    scale = src / dst
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), min(int(np.floor(f2)), src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            A[d, s1 - 1] += np.float32((s1 - f1) / cell)
        A[d, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            A[d, s2] += np.float32(min(f2 - s2, 1.0, cell) / cell)
    return A


def _area_linear_weights(dst: int, src: int) -> np.ndarray:
    """OpenCV's INTER_AREA along an axis when either axis grows: two linear
    taps, the upper weight frac((d + 1) - (s + 1) dst / src) past 0 with s
    = floor(d src / dst), clamped at the last pixel; [dst, src]."""
    A = np.zeros((dst, src), np.float64)
    for d in range(dst):
        s = int(np.floor(d * (src / dst)))
        f = np.float32((d + 1) - (s + 1) * (dst / src))
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if s >= src - 1:
            s, f = src - 1, np.float32(0.0)
        A[d, s] += np.float32(1.0 - f)
        A[d, min(s + 1, src - 1)] += f
    return A


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Resize of a float [h, w, ...] image to [H, W, ...] as OpenCV's
    INTER_AREA computes it: a box mean at integer shrinking factors,
    fractional-area weights at other shrinking factors, and OpenCV's
    area-style linear taps on both axes where either grows."""
    x = np.asarray(img, np.float32).astype(np.float64)
    h, w = x.shape[:2]
    if h % H == 0 and w % W == 0:
        out = x.reshape(H, h // H, W, w // W, *x.shape[2:]).mean(axis=(1, 3))
        return out.astype(np.float32)
    taps = _area_linear_weights if (H > h or W > w) else _area_weights
    out = np.tensordot(taps(H, h), x, axes=(1, 0))  # [H, w, ...]
    out = np.moveaxis(np.tensordot(taps(W, w), out, axes=(1, 1)), 0, 1)
    return out.astype(np.float32)


def resize_nearest(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Nearest resize of [h, w, ...] to [H, W, ...] as OpenCV's
    INTER_NEAREST picks: source index floor(i * src / dst)."""
    h, w = img.shape[:2]
    rows = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(
        np.int64), h - 1)
    cols = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(
        np.int64), w - 1)
    return img[rows][:, cols]


def _linear_taps(dst: int, src: int):
    """OpenCV's INTER_LINEAR taps along one axis: half-pixel centres,
    clamped at both edges, the position and its fraction in float64 (as
    OpenCV 5 takes them; within an fp32 rounding of OpenCV 4's float
    ones).  Returns (lower index, lower weight, upper weight)."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    f[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    top = i0 >= src - 1
    f[top] = 0.0
    i0[top] = src - 1
    return i0, (1.0 - f).astype(np.float32), f.astype(np.float32)


def resize_linear(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear resize of a float32 [h, w] image to [H, W] as OpenCV's
    INTER_LINEAR computes it: a horizontal pass, then a vertical one
    (within two fp32 roundings of cv2.resize)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    c0, a0, a1 = _linear_taps(W, w)
    r0, b0, b1 = _linear_taps(H, h)
    c1, r1 = np.minimum(c0 + 1, w - 1), np.minimum(r0 + 1, h - 1)
    rows = img[:, c0] * a0 + img[:, c1] * a1  # [h, W]
    return rows[r0] * b0[:, None] + rows[r1] * b1[:, None]


def load_object_masks(mask_root: str, img_names, H: int, W: int,
                      seed: int = 0, auto_seg: bool = False):
    """Load {stem}_obj_mask.npy files (the decode output: [1, H, W] uint8
    labels) with validity gating: a view is valid when its
    valid_dict.json score is > 0.5 and its mask has >= 10 foreground
    pixels; more than 25 valid views are subsampled ::3, topped up to 25
    with views drawn (with replacement) from a numpy Generator seeded with
    `seed`.  auto_seg: every view with a mask file is valid, none is
    dropped or drawn.

    Returns (masks [V, H, W] int32 labels, valid indices [K] int64)."""
    valid_path = os.path.join(mask_root, "valid_dict.json")
    valid = {}
    if os.path.exists(valid_path):
        with open(valid_path) as f:
            valid = json.load(f)
    masks = np.zeros((len(img_names), H, W), dtype=np.int32)
    valid_idx = []
    for i, name in enumerate(img_names):
        stem = os.path.splitext(str(name))[0]
        p = os.path.join(mask_root, f"{stem}_obj_mask.npy")
        if not os.path.exists(p):
            continue
        m = np.load(p)
        if m.ndim == 3:
            # [1, H, W]; per-class probability maps are argmaxed
            m = m[0] if m.shape[0] == 1 else (
                m.argmax(0) if m.shape[0] < m.shape[-1] else m.argmax(-1))
        if m.shape != (H, W):
            m = resize_nearest(m.astype(np.uint8), H, W)
        masks[i] = m.astype(np.int32)
        score = float(valid.get(stem, 1))
        if auto_seg or ((m > 0).sum() >= 10 and score > 0.5):
            valid_idx.append(i)
    valid_idx = np.asarray(valid_idx, np.int64)
    if not auto_seg and valid_idx.shape[0] > 25:
        sub = valid_idx[::3]
        if sub.shape[0] < 25:
            extra = np.random.default_rng(seed).choice(valid_idx,
                                                       25 - sub.shape[0])
            sub = np.concatenate([sub, extra])
        valid_idx = sub
    return masks, valid_idx
