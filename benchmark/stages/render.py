"""Render: a closed loop of `Trainer.render_view` calls, one client that
asks for the next view once the last is back, on poses along an orbit
drawn from the seed.

The numbers compared: the answers the check sampled from the window, each
view against the reference's render of its pose:
  image_rmse  the widest RMS difference of a view's colours;
  depth_rel   the widest RMS difference of a view's depth over the
              reference's mean depth."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness.drivers import span, sync
from benchmark.harness.scene import llff_poses, look_at_pose
from benchmark.reference import steps as ref_steps
from benchmark.stages import nerf

scene = nerf.scene
counts = nerf.counts


def orbit_poses(poses: np.ndarray, n: int, rng: np.random.Generator,
                elevation=(0.25, 0.6)) -> np.ndarray:
    """n poses on a circle around the point the cameras look at, at their
    mean distance, the start angle and the elevation drawn from rng."""
    o = poses[:, :3, 3].astype(np.float64)
    d = -poses[:, :3, 2].astype(np.float64)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    A = sum(np.eye(3) - np.outer(v, v) for v in d)
    b = sum((np.eye(3) - np.outer(v, v)) @ p for v, p in zip(d, o))
    c = np.linalg.solve(A, b)
    up = poses[:, :3, 1].mean(0).astype(np.float64)
    up /= np.linalg.norm(up)
    e1 = np.cross(up, [1.0, 0.0, 0.0])
    if np.linalg.norm(e1) < 1e-3:
        e1 = np.cross(up, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(up, e1)
    r = np.linalg.norm(o - c, axis=-1).mean()
    th0 = rng.uniform(0, 2 * np.pi)
    phi = rng.uniform(*elevation)
    out = []
    for k in range(n):
        th = th0 + 2 * np.pi * k / n
        eye = c + r * (np.cos(phi) * (np.cos(th) * e1 + np.sin(th) * e2)
                       + np.sin(phi) * up)
        out.append(look_at_pose(eye, c, up))
    return np.stack(out).astype(np.float32)


class Driver(nerf.NerfDriver):
    KEEP = nerf.NerfDriver.KEEP + ("answers", "keep", "poses", "intr", "H",
                                   "W")

    def setup(self):
        self.build()
        v = self.tr["views"]
        self.H, self.W = v["H"], v["W"]
        focal = 0.5 * self.H / np.tan(0.5 * np.deg2rad(v["fovy"]))
        self.intr = np.array([focal, focal, self.W / 2, self.H / 2],
                             np.float32)
        rng = np.random.default_rng(self.seed)
        self.poses = orbit_poses(llff_poses(self.scene["poses"]),
                                 v["orbit"], rng)
        within = self.tr["check"]["within"]
        self.keep = set(int(i) for i in rng.choice(
            within, self.tr["check"]["views"], replace=False))
        self.answers: Dict[int, dict] = {}
        self.k = 0
        for i in range(self.tr["warmup_views"]):
            self.trainer.render_view(self.poses[-1 - i], self.intr, self.H,
                                     self.W)
        sync(self.device)
        self.mark("warm-up")

    def _view(self, tracing: bool):
        k = self.k
        with span(tracing, "render_view"):
            out = self.trainer.render_view(self.poses[k % len(self.poses)],
                                           self.intr, self.H, self.W)
        if self.fault == "half":
            out["image"][out["image"].shape[0] // 2:] = 0.0
        elif self.fault == "altered":
            out["image"] = out["image"] + 0.02
        if k in self.keep:
            self.answers[k] = {"image": out["image"], "depth": out["depth"]}
        self.k += 1

    def window(self, seconds: float, tracing: bool = False,
               steps: Optional[int] = None) -> dict:
        lat, t0 = [], time.perf_counter()
        while (len(lat) < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            t = time.perf_counter()
            self._view(tracing)
            lat.append(time.perf_counter() - t)
        dt = time.perf_counter() - t0
        # the client asks on, uncounted, for sampled views a short window
        # did not reach
        while self.k <= max(self.keep):
            self._view(False)
        return {"views": len(lat), "rays": len(lat) * self.H * self.W,
                "seconds": dt, "latency_s": lat, "steps": len(lat)}


def render_reference(driver, modes: Dict[str, str], keys) -> Dict[int, dict]:
    """The reference's render of each sampled view's pose."""
    dev = driver.device
    rcfg = nerf.ref_config(driver.cell)
    params = {n: v.detach().clone() for n, v in driver.params.items()}
    field = ref_steps.make_field(rcfg, params, modes)
    intr = torch.as_tensor(driver.intr, device=dev)
    out = {}
    for k in keys:
        pose = torch.as_tensor(driver.poses[k % len(driver.poses)],
                               device=dev)
        img, dep = ref_steps.render_view(field, pose, intr, driver.H,
                                         driver.W, rcfg, rcfg["chunk"])
        out[k] = {"image": img.cpu().numpy(), "depth": dep.cpu().numpy()}
    return out


def render_numbers(prog: Dict[int, dict], ref: Dict[int, dict]):
    img = dep = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None:
            return {"image_rmse": float("inf"), "depth_rel": float("inf")}
        img = max(img, float(np.sqrt(np.mean((p["image"] - r["image"]) ** 2))))
        dep = max(dep, float(np.sqrt(np.mean((p["depth"] - r["depth"]) ** 2))
                             / max(np.mean(np.abs(r["depth"])), 1e-30)))
    return {"image_rmse": img, "depth_rel": dep}


def numbers(driver, control: bool = False):
    prec = driver.cell.config["precision"]
    keys = sorted(driver.keep)
    prog = (render_reference(driver, prec["control"], keys) if control
            else driver.answers)
    return render_numbers(prog, render_reference(driver, prec["stated"],
                                                 keys))
