"""Host-side loop of stage 1: training epochs, checkpoints and resume,
full-frame render, evaluation and test artifacts.  The eval renders use the
EMA weights, as the JAX trainer does.  The stage-2 and stage-3 loops
(stages.py) use the same Trainer, usually with an init checkpoint: its
parameters are loaded and frozen, and `backbone_frozen` tells the distill
and mask steps they may render the backbone without gradient (through the
level kernels on the MLP field; the hash-grid field has none and renders
through the composable route).  Without one nothing is frozen and those
steps render through the composable route.

Epoch math as the reference's: steps_per_epoch = number of training views,
max_epoch = ceil(iters / steps_per_epoch), eval and save intervals from
eval_cnt and save_cnt; the EMA is updated on the last step of each epoch.
Multi-GPU comes with a later slice.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.png import write_png
from ..data.provider import Scene
from ..data.rays import full_frame_rays
from ..data.sampler import sample_rgb_batch
from ..models.mlp_field import MLPField
from .checkpoints import CheckpointManager
from .metrics import PSNRMeter
from .state import (TrainState, freeze_mask_from_loaded, mlp_field_lr_scales,
                    partial_load)
from .steps import make_eval_render, make_rgb_train_step

# top-level parameter names of the stage-1 backbone (JAX trainer.py:50-52):
# the MLP field's, then the hash-grid field's.  The JAX list also names
# `sigma_mlp`, which no field has; the hash-grid field's density MLP is
# `grid_mlp`.
_BACKBONE_KEYS = ("trunk", "prop_mlp_0", "prop_mlp_1", "view_mlp",
                  "cp_x", "cp_y", "cp_z",
                  "grid", "prop_grid_0", "prop_grid_1", "grid_mlp")


def backbone_all_frozen(model, frozen) -> bool:
    """True iff every backbone parameter of the model is frozen."""
    hits = [n in frozen for n, _ in model.named_parameters()
            if n.split(".")[0] in _BACKBONE_KEYS]
    return bool(hits) and all(hits)


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
    def __init__(self, name: str, cfg: Config, model, workspace: str,
                 resume: bool = True, init_params: Optional[dict] = None):
        """resume: start from the workspace's newest checkpoint if there is
        one; else from the model's weights as given.  init_params: a
        state_dict handed over from an earlier stage; its tensors are
        loaded into the model and frozen."""
        self.name = name
        self.cfg = cfg
        self.model = model
        self.workspace = workspace
        self.device = next(model.parameters()).device
        self.log = Logger(workspace, name)
        self.ckpt = CheckpointManager(workspace, max_keep=2)
        frozen = set()
        if init_params is not None:
            loaded = partial_load(model, init_params)
            frozen = freeze_mask_from_loaded(model, init_params)
            self.log(f"[INFO] loaded {len(loaded)} param tensors from init "
                     "checkpoint (frozen)")
        self.backbone_frozen = backbone_all_frozen(model, frozen)
        # the lr scales are the MLP field's; any other field trains every
        # parameter at the base lr, as in JAX
        scales = (mlp_field_lr_scales(model) if isinstance(model, MLPField)
                  else None)
        self.state = TrainState(model, cfg.lr, cfg.iters, lr_scales=scales,
                                frozen=frozen)
        restored = self.ckpt.restore(self.device) if resume else None
        self.resumed = restored is not None
        if self.resumed:
            try:
                self.state.load_state_dict(restored)
                self.log(f"[INFO] resumed at step {self.state.step}")
            except ValueError:
                # the JAX trainer's best-effort optimizer restore
                # (trainer.py:108-131)
                self.state.load_state_dict(restored, weights_only=True)
                self.log("[WARN] checkpoint optimizer state does not match "
                         "the current optimizer; loaded model weights only "
                         f"(resumed at step {self.state.step})")
        self.train_step = make_rgb_train_step(model, cfg)
        self.eval_render = make_eval_render(self.state.ema_model, cfg)
        self._eval_render_perturb = None
        self._train_data = None
        self.best_metric = -np.inf
        self.stats = {"loss": []}

    def _to_device(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # -- stage 1 -----------------------------------------------------------
    def prepare_training(self, scene: Scene):
        """Put the training views on the device and seed the generator that
        draws the batches and the jitter (from the config and the step
        resumed at); `train` and `train_one_step` draw from them.  With
        adaptive_num_rays the ray count is set here."""
        cfg = self.cfg
        if cfg.adaptive_num_rays:
            # the reference rescales num_rays each step so that num_rays *
            # num_steps[-1] == num_points; with fixed per-level sample
            # counts that recursion sits at its fixed point after one step
            target = max(1, cfg.num_points // cfg.num_steps[-1])
            if target != cfg.num_rays:
                self.log(f"[INFO] adaptive_num_rays: {cfg.num_rays} -> "
                         f"{target} (num_points {cfg.num_points} / "
                         f"final-level samples {cfg.num_steps[-1]})")
                cfg = self.cfg = cfg.replace(num_rays=target)
        gen = torch.Generator(self.device)
        gen.manual_seed(cfg.seed * 1000003 + self.state.step)
        self._train_data = dict(
            images=self._to_device(scene.images),
            poses=self._to_device(scene.poses),
            intr=self._to_device(scene.intrinsics),
            cnf=(self._to_device(scene.cam_near_far)
                 if cfg.enable_cam_near_far
                 and scene.cam_near_far is not None else None),
            gen=gen)

    def train_one_step(self) -> dict:
        """One optimizer step on a batch drawn from the views that
        `prepare_training` put on the device.  The EMA is not updated."""
        d = self._train_data
        batch = sample_rgb_batch(
            d["gen"], d["images"], d["poses"], d["intr"], self.cfg.num_rays,
            random_image_batch=self.cfg.random_image_batch,
            cam_near_far=d["cnf"])
        return self.train_step(self.state, batch, d["gen"])

    def train(self, scene: Scene, val_scene: Optional[Scene] = None,
              max_epoch: Optional[int] = None):
        self.prepare_training(scene)
        cfg = self.cfg
        steps_per_epoch = scene.poses.shape[0]
        if max_epoch is None:
            max_epoch = int(np.ceil(cfg.iters / steps_per_epoch))
        eval_interval = max(1, max_epoch // max(1, cfg.eval_cnt))
        save_interval = max(1, max_epoch // max(1, cfg.save_cnt))
        self.log(f"[INFO] max_epoch {max_epoch}, eval every {eval_interval}, "
                 f"save every {save_interval}")

        t_start = time.time()
        step0 = self.state.step
        metrics = None
        for epoch in range(1, max_epoch + 1):
            k = min(steps_per_epoch, cfg.iters - self.state.step)
            if k <= 0:
                break
            for _ in range(k):
                metrics = self.train_one_step()
            self.state.update_ema()
            step = self.state.step
            loss = float(metrics["loss"])
            self.stats["loss"].append(loss)
            self.log(f"[epoch {epoch}/{max_epoch}] step {step} "
                     f"loss={loss:.5f} train_psnr={float(metrics['psnr']):.2f} "
                     f"lr={self.state.lr(step):.5f}")
            if epoch % save_interval == 0 or epoch == max_epoch:
                self.ckpt.save(step, self.state.state_dict())
            if val_scene is not None and (epoch % eval_interval == 0
                                          or epoch == max_epoch):
                score = self.evaluate(val_scene)
                if score > self.best_metric:
                    self.best_metric = score
                    self.ckpt.save(step, self.state.state_dict(), best=True)
            if step >= cfg.iters:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t_start
        n = self.state.step - step0
        self.log(f"[INFO] training took {dt / 60:.2f} min "
                 f"({n / max(dt, 1e-9):.1f} steps/s)")

    def render_view(self, pose, intrinsics, H, W, cam_near_far=None,
                    bg_color=1.0, aabb=None, generator=None):
        """Full-frame render with the EMA weights.  `aabb` overrides the
        inference bounding box; `generator` jitters sampling (a perturbed
        render is built on first use).  Returns numpy arrays
        {'image' [H*W, 3], 'depth' [H*W], 'weights_sum' [H*W]}."""
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
                    self.state.ema_model, self.cfg, perturb=True)
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

    def test(self, scene: Scene, save_dir: Optional[str] = None,
             write_video: bool = False, extra: Optional[str] = None):
        """Render every pose and save {stem}_rgb.png / {stem}_depth.npy;
        log an [EVAL] PSNR line when the scene has ground truth.
        write_video also writes the frames as save_dir/video.mp4 where
        imageio and imageio-ffmpeg are installed (the trajectory
        renders).
        extra='sam' (--return_extra with --with_sam) also saves each view's
        rendered SAM features through its low-res feature camera, with
        the live weights, to {stem}_sam.npy [h, w, 256] (JAX
        trainer.py:416-470)."""
        if extra not in (None, "sam"):
            raise ValueError(f"unknown extra output {extra!r}")
        save_dir = save_dir or os.path.join(self.workspace, "results")
        os.makedirs(save_dir, exist_ok=True)
        meter = PSNRMeter()
        frames = []
        for i in range(scene.poses.shape[0]):
            out, pred = self._render_scene(scene, i)
            stem = self._stem(scene, i)
            _save_image(os.path.join(save_dir, f"{stem}_rgb.png"), pred)
            np.save(os.path.join(save_dir, f"{stem}_depth.npy"),
                    out["depth"].reshape(scene.H, scene.W))
            if extra == "sam":
                from .stages import render_features

                intr = (scene.intrinsics[i] if scene.intrinsics.ndim == 2
                        else scene.intrinsics)
                feats = render_features(self, scene.poses[i], intr, scene.H,
                                        scene.W)
                np.save(os.path.join(save_dir, f"{stem}_sam.npy"),
                        feats.cpu().numpy())
            if scene.images is not None:
                meter.update(pred, scene.images[i][..., :3])
            if write_video:
                frames.append((pred * 255).astype(np.uint8))
        if meter.N:
            self.log("[EVAL] " + meter.report())
        if frames:
            _write_video(os.path.join(save_dir, "video.mp4"), frames)
        self.log(f"[INFO] test results saved to {save_dir}")


def _save_image(path: str, img: np.ndarray):
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def _write_video(path: str, frames, fps: int = 24) -> bool:
    """frames: uint8 [H, W, 3] each.  Without imageio or its ffmpeg plugin
    (imageio-ffmpeg, which writes .mp4) only the frames stay and a warning
    says so; any other failure of the write raises.  Returns whether the
    video was written."""
    try:
        import imageio
        import imageio_ffmpeg  # noqa: F401
    except ImportError as e:
        print(f"[WARN] video write failed ({e}); saving frames only")
        return False
    imageio.mimwrite(path, frames, fps=fps, quality=8)
    return True
