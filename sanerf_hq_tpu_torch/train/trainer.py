"""Host-side loop for inference: full-frame render, evaluation and test
artifacts.  Training, checkpoints and multi-GPU come with later slices."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.png import write_png
from ..data.provider import Scene
from ..data.rays import full_frame_rays
from .metrics import PSNRMeter
from .steps import make_eval_render


class Logger:
    """Console + append-mode log file in the workspace."""

    def __init__(self, workspace: str, name: str = "ngp"):
        os.makedirs(workspace, exist_ok=True)
        self.path = os.path.join(workspace, f"log_{name}.txt")

    def __call__(self, *args):
        msg = " ".join(str(a) for a in args)
        print(msg, flush=True)
        with open(self.path, "a") as f:
            f.write(msg + "\n")


class Trainer:
    def __init__(self, name: str, cfg: Config, model, workspace: str):
        self.name = name
        self.cfg = cfg
        self.model = model
        self.workspace = workspace
        self.device = next(model.parameters()).device
        self.log = Logger(workspace, name)
        self.eval_render = make_eval_render(model, cfg)
        self._eval_render_perturb = None

    def render_view(self, pose, intrinsics, H, W, cam_near_far=None,
                    bg_color=1.0, aabb=None, generator=None):
        """Full-frame render.  `aabb` overrides the inference bounding box;
        `generator` jitters sampling (a perturbed render is built on first
        use).  Returns numpy arrays {'image' [H*W, 3], 'depth' [H*W],
        'weights_sum' [H*W]}."""
        dev = self.device
        ro, rd = full_frame_rays(
            torch.as_tensor(np.asarray(pose, np.float32), device=dev),
            torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev),
            H, W)
        cnf = None
        if cam_near_far is not None:
            cnf = torch.as_tensor(np.asarray(cam_near_far, np.float32),
                                  device=dev).reshape(1, 2)
        render = self.eval_render
        if generator is not None:
            if self._eval_render_perturb is None:
                self._eval_render_perturb = make_eval_render(
                    self.model, self.cfg, perturb=True)
            render = self._eval_render_perturb
        out = render(ro, rd, bg_color=bg_color, cam_near_far=cnf,
                     aabb=None if aabb is None else torch.as_tensor(
                         aabb, dtype=torch.float32, device=dev),
                     generator=generator)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _render_scene(self, scene: Scene, i: int):
        intr = (scene.intrinsics[i] if scene.intrinsics.ndim == 2
                else scene.intrinsics)
        cnf = scene.cam_near_far[i] if scene.cam_near_far is not None else None
        out = self.render_view(scene.poses[i], intr, scene.H, scene.W,
                               cam_near_far=cnf)
        return out, out["image"].reshape(scene.H, scene.W, 3)

    @staticmethod
    def _stem(scene: Scene, i: int) -> str:
        name = scene.img_names[i] if scene.img_names is not None else f"{i:04d}"
        return os.path.splitext(str(name))[0]

    def evaluate(self, scene: Scene, meters=None,
                 save_dir: Optional[str] = None,
                 max_views: Optional[int] = None) -> float:
        meters = meters or [PSNRMeter()]
        n = scene.poses.shape[0] if max_views is None else min(
            max_views, scene.poses.shape[0])
        for i in range(n):
            out, pred = self._render_scene(scene, i)
            gt = None
            if scene.images is not None:
                gt = scene.images[i][..., :3]
                for m in meters:
                    m.update(pred, gt)
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                stem = self._stem(scene, i)
                _save_image(os.path.join(save_dir, f"{stem}_rgb.png"), pred)
                np.save(os.path.join(save_dir, f"{stem}_depth.npy"),
                        out["depth"].reshape(scene.H, scene.W))
                if gt is not None:
                    _save_image(os.path.join(save_dir, f"{stem}_gt.png"), gt)
                    err = np.abs(gt.astype(np.float32) - pred).mean(-1)
                    _save_image(os.path.join(save_dir, f"{stem}_error.png"),
                                np.repeat(err[..., None], 3, -1))
        for m in meters:
            self.log("[EVAL] " + m.report())
        return meters[0].measure() if meters else 0.0

    def test(self, scene: Scene, save_dir: Optional[str] = None):
        """Render every pose and save {stem}_rgb.png / {stem}_depth.npy;
        log an [EVAL] PSNR line when the scene has ground truth."""
        save_dir = save_dir or os.path.join(self.workspace, "results")
        os.makedirs(save_dir, exist_ok=True)
        meter = PSNRMeter()
        for i in range(scene.poses.shape[0]):
            out, pred = self._render_scene(scene, i)
            stem = self._stem(scene, i)
            _save_image(os.path.join(save_dir, f"{stem}_rgb.png"), pred)
            np.save(os.path.join(save_dir, f"{stem}_depth.npy"),
                    out["depth"].reshape(scene.H, scene.W))
            if scene.images is not None:
                meter.update(pred, scene.images[i][..., :3])
        if meter.N:
            self.log("[EVAL] " + meter.report())
        self.log(f"[INFO] test results saved to {save_dir}")


def _save_image(path: str, img: np.ndarray):
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
