"""Test-pose synthesis for `--render_trajectory` / `--circle` and the replay
of the viewer's recorded trajectories (`--trajectory_root`): circular
orbits and slerp interpolation with a sine easing.  numpy only.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .colmap import qvec2rotmat, rotmat2qvec
from .synthetic import look_at_pose


def slerp(q0, q1, t):
    """Spherical interpolation of unit quaternions (the shorter arc; a
    normalised lerp when they are within 0.9995)."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(
        theta)


def interpolate_poses(poses, num_frames: int = 10):
    """Between each pair of consecutive poses, num_frames + 1 poses (both
    ends included): rotation by slerp, translation by lerp, both at the
    eased ratio sin((j / num_frames - 0.5) pi) / 2 + 1/2.  Returns
    [(len(poses) - 1) * (num_frames + 1), 4, 4] float32."""
    out = []
    for i in range(1, len(poses)):
        p0, p1 = poses[i - 1], poses[i]
        q0 = rotmat2qvec(p0[:3, :3])
        q1 = rotmat2qvec(p1[:3, :3])
        for j in range(num_frames + 1):
            ratio = np.sin(((j / num_frames) - 0.5) * np.pi) * 0.5 + 0.5
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = qvec2rotmat(slerp(q0, q1, ratio))
            pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
            out.append(pose)
    return np.stack(out)


def circle_poses(radius: float = 1.0, elevation: float = 0.3,
                 n_frames: int = 60, center=(0.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0)):
    """n_frames poses on a circle of `radius` at `elevation` above
    `center`, each looking at it."""
    poses = []
    for i in range(n_frames):
        theta = 2 * np.pi * i / n_frames
        eye = np.array([
            center[0] + radius * np.cos(theta),
            center[1] + elevation,
            center[2] + radius * np.sin(theta),
        ], np.float32)
        poses.append(look_at_pose(eye, center, up))
    return np.stack(poses)


def synthesize_test_poses(train_poses, camera_traj: str = "interp",
                          n_frames: int = 60):
    """'circle': n_frames poses on a circle at the training cameras' mean
    distance from the origin; else about n_frames poses interpolated along
    the training cameras."""
    if camera_traj == "circle":
        radius = float(np.linalg.norm(train_poses[:, :3, 3], axis=-1).mean())
        return circle_poses(radius=radius, n_frames=n_frames)
    return interpolate_poses(
        train_poses, max(1, n_frames // max(len(train_poses) - 1, 1)))


def load_recorded_trajectories(trajectory_root: str, interp_frames: int = 8,
                               resolution: int = 1024, fovy_deg: float = 60.0):
    """Replay the viewer's saved trajectories: each json file in
    trajectory_root (sorted by name) holds {'trajectory': [[4x4 pose],
    ...]}; its keyframes are interpolated with `interp_frames` steps and
    named f'{file:04d}_{frame:04d}', for a square camera of `resolution`
    at fovy `fovy_deg`.

    Returns (poses [N, 4, 4], intrinsics [4], img_names [N])."""
    poses, names = [], []
    for i, fname in enumerate(sorted(os.listdir(trajectory_root))):
        with open(os.path.join(trajectory_root, fname)) as f:
            data = json.load(f)
        keyframes = [np.asarray(fr, np.float32).reshape(-1, 4, 4)[0]
                     for fr in data["trajectory"]]
        cur = interpolate_poses(np.stack(keyframes), interp_frames)
        names.extend(f"{i:04d}_{j:04d}" for j in range(len(cur)))
        poses.extend(cur)
    focal = resolution / (2 * np.tan(0.5 * np.deg2rad(fovy_deg)))
    intrinsics = np.array([focal, focal, resolution / 2, resolution / 2],
                          np.float32)
    return np.stack(poses), intrinsics, np.array(names)
