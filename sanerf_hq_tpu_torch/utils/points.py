"""3-D point prompts for the decode: the point file (the schema of
example_points.json) and their projection into a view, with the screen
bounds, the depth gate against the rendered depth and the validity gate
(a copy of the JAX package's utils/points.py)."""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PointPrompts:
    points: np.ndarray          # [N, 3] world coordinates
    labels: np.ndarray          # [N] 1 positive, 0 negative
    crucial_label: np.ndarray   # [N] 1 if crucial
    crucial_count: int
    valid_threshold: int


def load_point_file(path: str) -> PointPrompts:
    """{"points": [[x, y, z], ...], "negative_labels": [i, ...],
    "crucial_point_index": [i, ...], "valid_threshold": k}; without a
    valid_threshold (or -1) a view needs int(0.8 * N) + 1 points."""
    with open(path) as f:
        pj = json.load(f)
    points = np.asarray(pj["points"], np.float32)
    labels = np.ones(points.shape[0], np.int32)
    for i in pj.get("negative_labels", []):
        labels[i] = 0
    crucial = np.zeros(points.shape[0], np.int32)
    for i in pj.get("crucial_point_index", []):
        crucial[i] = 1
    vt = int(pj.get("valid_threshold", -1))
    if vt == -1:
        vt = int(points.shape[0] * 0.8) + 1
    return PointPrompts(points, labels, crucial,
                        len(pj.get("crucial_point_index", [])), vt)


def project_points_to_view(prompts: PointPrompts, pose: np.ndarray,
                           intrinsics: np.ndarray, H: int, W: int,
                           pred_depth: Optional[np.ndarray] = None,
                           depth_tol: float = 0.05,
                           info: Optional[dict] = None):
    """Project the world points into a view: x = W - (fx X / Z + cx) (the
    reference's flip), y = fy Y / Z + cy, truncated to pixels; off-screen
    points dropped, and with pred_depth those whose camera depth differs
    from the rendered depth at their pixel by more than depth_tol.  The
    view is valid if every crucial point and at least valid_threshold
    points survive.  Returns (coords [M, 2] int32 (x, y), labels [M],
    crucial [M], is_valid), or (None, None, None, False) if none survive;
    `info`, if a dict, gets "depth_err" of the on-screen points."""
    pts_h = np.concatenate(
        [prompts.points, np.ones_like(prompts.points[:, :1])], axis=-1)
    cam = pts_h @ np.linalg.inv(pose).T
    fx, fy, cx, cy = intrinsics[:4]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = (W - (fx * cam[:, 0] / cam[:, 2] + cx)).astype(np.int64)
        y = (fy * cam[:, 1] / cam[:, 2] + cy).astype(np.int64)
    coords = np.stack([x, y], axis=-1)
    screen = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    if not screen.any():
        return None, None, None, False
    coords = coords[screen]
    labels = prompts.labels[screen]
    crucial = prompts.crucial_label[screen]
    if pred_depth is not None:
        err = np.abs(-cam[screen, 2] - pred_depth[coords[:, 1], coords[:, 0]])
        if info is not None:
            info["depth_err"] = err
        unoccluded = err <= depth_tol
        if not unoccluded.any():
            return None, None, None, False
        coords = coords[unoccluded]
        labels = labels[unoccluded]
        crucial = crucial[unoccluded]
    is_valid = (crucial.sum() >= prompts.crucial_count) and (
        crucial.shape[0] >= prompts.valid_threshold)
    return coords.astype(np.int32), labels, crucial, bool(is_valid)
