"""Stage-3 loops: object-field training with the error map, the mask
renders and the mIoU evaluation (the JAX package's train/stages.py).
Stage 2 (the SAM feature container) and decode are not ported yet
(ROADMAP.md, queue 1, M8-M10).

The stage-3 renders use the live parameters (`trainer.model`), as the JAX
stage functions render `trainer.state.params`: the mask step never updates
the EMA, so the EMA copy would still hold the mask heads' initial weights.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.provider import Scene, resize_linear, resize_nearest
from ..data.rays import full_frame_rays
from ..data.sampler import fixed_fovy_intrinsics, sample_mask_batch
from ..utils.overlays import overlay_mask
from .metrics import MeanIoUMeter
from .steps import make_eval_render, make_mask_train_step
from .trainer import Trainer, _save_image


def train_mask(trainer: Trainer, scene: Scene, iters: Optional[int] = None):
    """Object-field training: `iters` mask steps (default cfg.iters) on
    error-map-guided batches of scene's views.  With --error_map the map is
    rebuilt from renders every ray_pair_rgb_iter steps.  Saves a checkpoint
    at the end and returns the error map [V, S*S]."""
    cfg = trainer.cfg
    iters = iters or cfg.iters
    if scene.masks is None:
        raise ValueError("stage 3 needs object masks (--mask_root)")
    dev = trainer.device
    mask_step = make_mask_train_step(trainer.model, cfg,
                                     frozen_backbone=trainer.backbone_frozen)
    S = cfg.error_map_size
    V = scene.poses.shape[0]
    error_map = torch.ones((V, S * S), dtype=torch.float32, device=dev)

    masks = scene.masks
    if cfg.use_default_intrinsics:
        intr = (scene.intrinsics[0] if scene.intrinsics.ndim == 2
                else scene.intrinsics)
        H, W = scene.H, scene.W
    else:
        # the reference's online camera: fovy 60 at online_resolution, with
        # the masks resampled to it
        H = W = cfg.online_resolution
        intr = fixed_fovy_intrinsics(cfg.online_resolution, 60.0)
        if masks.shape[1:] != (H, W):
            masks = np.stack([resize_nearest(m, H, W) for m in masks])
    masks_t = torch.as_tensor(masks, dtype=torch.long, device=dev)
    poses_t = torch.as_tensor(np.asarray(scene.poses, np.float32), device=dev)
    intr_t = torch.as_tensor(np.asarray(intr, np.float32), device=dev)
    gen = torch.Generator(dev)
    gen.manual_seed(cfg.seed * 1000003 + trainer.state.step)

    step = step0 = trainer.state.step
    trainer.stats["mask"] = []
    t_start = time.time()
    while step < iters:
        batch = sample_mask_batch(
            gen, masks_t, poses_t, intr_t, error_map, cfg.num_rays,
            cfg.num_local_sample, cfg.local_sample_patch_size, H, W, S,
            use_error_map=cfg.error_map)
        metrics, error_map = mask_step(trainer.state, batch, gen, error_map)
        step += 1
        if cfg.error_map and cfg.ray_pair_rgb_iter > 0 and \
                step % cfg.ray_pair_rgb_iter == 0:
            error_map = update_error_map(trainer, masks, scene.poses, intr,
                                         H, W)
            trainer.log(f"[INFO] error map rebuilt at step {step}")
        if step == step0 + 1 or step % 20 == 0 or step == iters:
            # the total jumps when the ray-pair loss switches on at
            # ray_pair_rgb_iter; ce alone is the comparable curve
            vals = {k: float(v) for k, v in metrics.items()}
            trainer.stats["mask"].append((step, vals))
            parts = "".join(f" {k}={vals[k]:.4f}"
                            for k in ("ce", "label_reg", "ray_pair")
                            if k in vals)
            trainer.log(f"[mask {step}/{iters}] loss={vals['loss']:.4f}"
                        f"{parts} acc={vals['acc']:.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t_start
    trainer.log(f"[INFO] mask training took {dt / 60:.2f} min "
                f"({(step - step0) / max(dt, 1e-9):.1f} steps/s)")
    trainer.ckpt.save(trainer.state.step, trainer.state.state_dict())
    return error_map


def render_instance_mask(trainer: Trainer, pose, intrinsics, H: int, W: int):
    """Mask probabilities [H, W, n_inst] (softmax of the rendered logits),
    image [H, W, 3] and depth [H, W] of one view, as numpy arrays."""
    if getattr(trainer, "_mask_render", None) is None:
        trainer._mask_render = make_eval_render(trainer.model, trainer.cfg,
                                                return_mask=True)
    dev = trainer.device
    ro, rd = full_frame_rays(
        torch.as_tensor(np.asarray(pose, np.float32), device=dev),
        torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev),
        H, W)
    out = trainer._mask_render(ro, rd)
    logits = out["instance_mask_logits"].cpu().numpy().reshape(
        H, W, trainer.cfg.n_inst)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    return (probs, out["image"].cpu().numpy().reshape(H, W, 3),
            out["depth"].cpu().numpy().reshape(H, W))


def downscale_intrinsics(intr, H: int, W: int, S: int):
    """[fx, fy, cx, cy] scaled per axis so that an S x S render is pixel-
    aligned with the H x W view resized to S x S (a world point at (u, v)
    lands at (u S/W, v S/H))."""
    fx, fy, cx, cy = np.asarray(intr, np.float32)
    sx, sy = S / W, S / H
    return np.array([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)


def update_error_map(trainer: Trainer, masks, poses, intr, H: int, W: int):
    """Render every view at error_map_size and rebuild the error map from
    the cosine of the probabilities to the (bilinearly downsized, rounded)
    ground truth: exp(-ray_pair_rgb_exp_weight * cos - epsilon).  masks
    [V, H, W] numpy labels.  Returns [V, S*S] on the trainer's device."""
    cfg = trainer.cfg
    S = cfg.error_map_size
    small = downscale_intrinsics(intr, H, W, S)
    rows = []
    for i in range(len(poses)):
        probs, _, _ = render_instance_mask(trainer, poses[i], small, S, S)
        gt = resize_linear(np.asarray(masks[i], np.float32), S, S)
        gt = np.rint(np.clip(gt, 0, cfg.n_inst - 1)).astype(np.int64)
        onehot = np.eye(cfg.n_inst, dtype=np.float32)[gt]
        cos = (probs * onehot).sum(-1) / np.maximum(
            np.linalg.norm(probs, axis=-1) * np.linalg.norm(onehot, axis=-1),
            1e-8)
        err = np.exp(-cfg.ray_pair_rgb_exp_weight * cos - cfg.epsilon)
        rows.append(err.reshape(-1))
    return torch.as_tensor(np.stack(rows).astype(np.float32),
                           device=trainer.device)


def evaluate_masks(trainer: Trainer, scene: Scene,
                   save_dir: Optional[str] = None,
                   render_mask_type: str = "heatmap") -> float:
    """Mean IoU of the object field's argmax labels against scene.masks
    (when it has them), logged as an [EVAL] MeanIoU line.  With save_dir,
    writes {stem}_mask.npy (probabilities [H, W, n_inst]) and
    {stem}_mask_vis.png: the label map ('mask'), the image where the label
    is not 0 ('composition'), or the image with the
    render_mask_instance_id probability > 0.5 overlaid ('heatmap')."""
    meter = MeanIoUMeter()
    for i in range(scene.poses.shape[0]):
        intr = (scene.intrinsics[i] if scene.intrinsics.ndim == 2
                else scene.intrinsics)
        probs, rgb, _ = render_instance_mask(trainer, scene.poses[i], intr,
                                             scene.H, scene.W)
        pred = probs.argmax(-1)
        if scene.masks is not None:
            meter.update(pred, scene.masks[i])
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            stem = os.path.splitext(str(scene.img_names[i]))[0]
            np.save(os.path.join(save_dir, f"{stem}_mask.npy"), probs)
            if render_mask_type == "mask":
                vis = np.repeat(pred[..., None].astype(np.float32), 3, -1)
            elif render_mask_type == "composition":
                vis = np.where((pred > 0)[..., None], rgb, 1.0)
            else:  # heatmap
                p1 = probs[..., min(trainer.cfg.render_mask_instance_id,
                                    probs.shape[-1] - 1)]
                vis = overlay_mask(rgb, p1 > 0.5)
            _save_image(os.path.join(save_dir, f"{stem}_mask_vis.png"), vis)
    trainer.log("[EVAL] " + meter.report())
    return meter.measure()
