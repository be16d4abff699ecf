"""The viewer's session: an orbit camera, one-frame renders at any pose and
downscale (with SPP accumulation of jittered renders), 3-D point prompts
picked through the rendered depth, keyframe recording, and training
ticks of a dynamic number of steps between frames.  `web_viewer.py`
serves it over HTTP; a notebook can drive it directly.

Frames render the trainer's EMA weights and ticks train its live weights
without updating the EMA (as the JAX package's ticks do), so training
ticks do not show in the frames.
"""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ..data.rays import rays_from_pixels


class OrbitCamera:
    """Orbit, pan and zoom around a centre; `version` counts the changes
    (SPP accumulation restarts when it moves)."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3, dtype=np.float32)
        self.up = np.array([0, 1, 0], np.float32)
        self.version = 0

    @property
    def pose(self) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.rot
        pose[:3, 3] = self.rot @ np.array([0, 0, self.radius], np.float32) \
            + self.center
        return pose

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(np.deg2rad(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2], np.float32)

    def orbit(self, dx: float, dy: float):
        def rotmat(axis, angle):  # Rodrigues
            axis = axis / np.linalg.norm(axis)
            K = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            return (np.eye(3) + np.sin(angle) * K
                    + (1 - np.cos(angle)) * K @ K).astype(np.float32)

        side = self.rot[:, 0]
        self.rot = rotmat(self.up, -dx * 0.005) @ rotmat(side, -dy * 0.005) \
            @ self.rot
        self.version += 1

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)
        self.version += 1

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 0.0005 * self.rot @ np.array([dx, dy, dz], np.float32)
        self.version += 1

    def set_fovy(self, fovy: float):
        self.fovy = float(np.clip(fovy, 10.0, 120.0))
        self.version += 1


class InteractiveSession:
    """One viewer's state over a Trainer; `scene` (training views) enables
    the training ticks."""

    def __init__(self, trainer, scene=None, W: int = 512, H: int = 512,
                 fovy: float = 60.0, radius: float = 2.0):
        self.trainer = trainer
        self.scene = scene
        self.camera = OrbitCamera(W, H, r=radius, fovy=fovy)
        self._train_steps = 16  # adapted to target_seconds after each tick
        self.bg_color = 1.0
        self.aabb: Optional[np.ndarray] = None  # the crop box
        self.spp = 1  # frames to accumulate at a still camera
        self.trajectory: list = []  # recorded keyframes
        self.points_3d: list = []
        self.point_labels: list = []
        self._accum = None  # [H, W, 3] running mean
        self._accum_n = 0
        self._accum_sig = None
        self._last_depth = None

    def set_aabb(self, lo=None, hi=None):
        """Clamp the inference box to [lo, hi] within the training bound;
        None resets it to the bound."""
        if lo is None and hi is None:
            self.aabb = None
        else:
            b = self.trainer.cfg.bound
            lo = np.clip(np.asarray(lo, np.float32), -b, b)
            hi = np.clip(np.asarray(hi, np.float32), -b, b)
            self.aabb = np.concatenate([lo, np.maximum(hi, lo + 1e-3)])
        self._accum_sig = None

    def record_pose(self) -> int:
        self.trajectory.append(self.camera.pose.copy())
        return len(self.trajectory)

    def save_trajectory(self, path: str) -> int:
        """Write the keyframes as {'trajectory': [[4x4], ...]}, the schema
        data/trajectory.py `load_recorded_trajectories` replays."""
        with open(path, "w") as f:
            json.dump({"trajectory": [p.tolist() for p in self.trajectory]},
                      f)
        return len(self.trajectory)

    def render_frame(self, pose: Optional[np.ndarray] = None,
                     downscale: int = 1) -> dict:
        """Render one frame at W/downscale x H/downscale, at `pose` or the
        camera's.  With spp > 1 at the camera's pose, successive calls with
        the same (camera version, downscale, background, fovy) average
        renders jittered by generators seeded 0, 1, 2, ... up to spp
        frames, then serve the mean; any change restarts it."""
        cam = self.camera
        explicit_pose = pose is not None
        pose = pose if explicit_pose else cam.pose
        H, W = cam.H // downscale, cam.W // downscale
        intr = cam.intrinsics / downscale
        intr[2], intr[3] = W / 2, H / 2
        t0 = time.perf_counter()

        sig = (cam.version, downscale, float(self.bg_color), cam.fovy)
        accumulating = self.spp > 1 and not explicit_pose
        if accumulating and sig == self._accum_sig \
                and self._accum_n >= self.spp:
            return {"image": self._accum, "depth": self._last_depth,
                    "spp": self._accum_n, "time": 0.0, "fps": float("inf")}
        accumulate = accumulating and sig == self._accum_sig
        gen = None
        if accumulating:
            gen = torch.Generator(self.trainer.device)
            gen.manual_seed(self._accum_n if accumulate else 0)
        out = self.trainer.render_view(pose, intr, H, W,
                                       bg_color=self.bg_color,
                                       aabb=self.aabb, generator=gen)
        img = out["image"].reshape(H, W, 3)
        if accumulating:
            if accumulate:
                self._accum = (self._accum * self._accum_n + img) / (
                    self._accum_n + 1)
                self._accum_n += 1
            else:
                self._accum = img
                self._accum_n = 1
                self._accum_sig = sig
            img = self._accum
        depth = out["depth"].reshape(H, W)
        self._last_depth = depth
        dt = time.perf_counter() - t0
        return {"image": img, "depth": depth,
                "spp": self._accum_n if self.spp > 1 else 1,
                "time": dt, "fps": 1.0 / max(dt, 1e-9)}

    def pick_point(self, px: int, py: int, label: int = 1,
                   dedup_dist: float = 0.01) -> Optional[np.ndarray]:
        """Unproject pixel (px, py) of a full-size frame at the camera
        through its rendered depth into a 3-D point prompt (label 1
        positive, 0 negative).  A pick within dedup_dist of a point already
        held removes that point instead (returns None)."""
        depth = self.render_frame()["depth"]
        H, W = depth.shape
        px = int(np.clip(px, 0, W - 1))
        py = int(np.clip(py, 0, H - 1))
        z = float(depth[py, px])
        ro, rd = rays_from_pixels(
            torch.as_tensor(self.camera.pose),
            torch.as_tensor(self.camera.intrinsics),
            torch.tensor([px + 0.5]), torch.tensor([py + 0.5]))
        point = ro[0].numpy() + rd[0].numpy() * z
        for i, p in enumerate(self.points_3d):
            if np.linalg.norm(p - point) < dedup_dist:
                self.points_3d.pop(i)
                self.point_labels.pop(i)
                return None
        self.points_3d.append(point)
        self.point_labels.append(label)
        return point

    def save_points(self, path: str):
        """Write the picked prompts in the --point_file schema that the
        decode reads (utils/points.py)."""
        out = {
            "points": [p.tolist() for p in self.points_3d],
            "negative_labels": [i for i, l in enumerate(self.point_labels)
                                if l == 0],
            "valid_threshold": -1,
            "crucial_point_index": [],
        }
        with open(path, "w") as f:
            json.dump(out, f, indent=4)

    def train_ticks(self, target_seconds: float = 0.5) -> dict:
        """Run the current tick size of training steps, then set the next
        tick's size so that it takes about target_seconds (1 to 256
        steps)."""
        if self.scene is None:
            raise ValueError("training ticks need a session with a scene")
        tr = self.trainer
        if tr._train_data is None:
            tr.prepare_training(self.scene)
        n = self._train_steps
        t0 = time.perf_counter()
        for _ in range(n):
            metrics = tr.train_one_step()
        loss = float(metrics["loss"])  # waits for the last step
        dt = time.perf_counter() - t0
        self._train_steps = int(np.clip(target_seconds / max(dt / n, 1e-4),
                                        1, 256))
        return {"loss": loss, "step": int(tr.state.step), "time": dt,
                "steps": n, "steps_per_sec": n / max(dt, 1e-9)}
