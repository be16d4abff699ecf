"""Scene loading, host-side (numpy): the `transforms.json` families
('llff', '3dfront'), the reference split logic, and the stage-3 object
masks (`load_object_masks`) with the two resizes the stage needs
(`resize_nearest`, `resize_linear`: OpenCV's INTER_NEAREST and, on float
images, INTER_LINEAR, in numpy).

'llff' / '3dfront': transforms.json with fl_x/fl_y/cx/cy + frames; ngp axis
permutation then y/z column flips; 3dfront recentres (center_poses) and
auto-scales.  The 'others', 'mip' and 'lerf' families are not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

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
    """RGB(A) float32 in [0, 1].  PNGs are read here; other formats need
    OpenCV."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.shape[-1] in (1, 2):  # grey (+ alpha)
            img = np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]],
                                 axis=-1)
    else:
        import cv2

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
    if data_type in ("others", "mip", "lerf"):
        raise NotImplementedError(
            f"data_type '{data_type}' is not ported yet (ROADMAP.md, queue 1, "
            "M5); use llff or 3dfront")
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


def _stack_images(paths, H, W):
    imgs = []
    for p in paths:
        img = _load_image(p)
        if img.shape[0] != H or img.shape[1] != W:
            import cv2

            img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
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
    clamped at both edges.  Returns (lower index, upper weight)."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    f[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    top = i0 >= src - 1
    f[top] = 0.0
    i0[top] = src - 1
    return i0, f.astype(np.float32)


def resize_linear(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear resize of a float32 [h, w] image to [H, W] as OpenCV's
    INTER_LINEAR computes it: a horizontal pass, then a vertical one."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    c0, fc = _linear_taps(W, w)
    r0, fr = _linear_taps(H, h)
    c1, r1 = np.minimum(c0 + 1, w - 1), np.minimum(r0 + 1, h - 1)
    rows = img[:, c0] * (1.0 - fc) + img[:, c1] * fc  # [h, W]
    return (rows[r0] * (1.0 - fr)[:, None]
            + rows[r1] * fr[:, None]).astype(np.float32)


def load_object_masks(mask_root: str, img_names, H: int, W: int,
                      seed: int = 0):
    """Load {stem}_obj_mask.npy files (the decode output: [1, H, W] uint8
    labels) with validity gating: a view is valid when its
    valid_dict.json score is > 0.5 and its mask has >= 10 foreground
    pixels; more than 25 valid views are subsampled ::3, topped up to 25
    with views drawn (with replacement) from a numpy Generator seeded with
    `seed`.

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
        if (m > 0).sum() >= 10 and score > 0.5:
            valid_idx.append(i)
    valid_idx = np.asarray(valid_idx, np.int64)
    if valid_idx.shape[0] > 25:
        sub = valid_idx[::3]
        if sub.shape[0] < 25:
            extra = np.random.default_rng(seed).choice(valid_idx,
                                                       25 - sub.shape[0])
            sub = np.concatenate([sub, extra])
        valid_idx = sub
    return masks, valid_idx
