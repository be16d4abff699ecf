"""The stage loops over a stage-1 Trainer (the JAX package's
train/stages.py): stage 2's two SAM feature containers, the cache
(`store_sam_features`) and the distill container (`train_sam_distill`,
with its rendered-feature MSE `evaluate_sam_features`), the point-prompt
decode (`decode`, from cached or rendered features), and stage 3:
object-field training with the error map, the mask renders and the mIoU
evaluation.

The feature and mask renders use the live parameters (`trainer.model`),
as the JAX stage functions render `trainer.state.params`: the distill and
mask steps never update the EMA, so the EMA copy would still hold the
heads' initial weights.  The RGB renders (`trainer.render_view`) use the
EMA weights, as in JAX; over a frozen backbone the two agree.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.provider import Scene, resize_linear, resize_nearest
from ..data.rays import full_frame_rays
from ..data.sampler import (fixed_fovy_intrinsics, sam_aug_intrinsics,
                            sample_mask_batch)
from ..render.renderer import RenderSettings, render_staged
from ..sam.predictor import PIXEL_MEAN, PIXEL_STD
from ..utils.cache import Cache
from ..utils.overlays import overlay_mask, overlay_point
from ..utils.points import PointPrompts, project_points_to_view
from ..utils.resize import resize_bilinear
from .metrics import MeanIoUMeter, MSEMeter
from .steps import (make_eval_render, make_mask_train_step,
                    make_sam_distill_step)
from .trainer import Trainer, _save_image


def _view_intrinsics(scene: Scene, i: int):
    return scene.intrinsics[i] if scene.intrinsics.ndim == 2 \
        else scene.intrinsics


def _rays(trainer: Trainer, pose, intrinsics, H: int, W: int):
    dev = trainer.device
    return full_frame_rays(
        torch.as_tensor(np.asarray(pose, np.float32), device=dev),
        torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev),
        H, W)


def lowres_feature_camera(intr, H: int, W: int, grid: int = 64):
    """The SAM-aligned low-res feature camera of an H x W view: (its
    intrinsics, h, w), h x w the view's aspect with the long side `grid`
    (SAM's resize-longest-side), the intrinsics scaled per axis so that the
    h x w render covers the whole view.  Feature pixel (u, v) then sits
    where the encoder's feature map has it once its bottom / right padding
    is stripped, which `SamPredictor.set_features` puts back."""
    M = max(H, W)
    h = int(H * grid / M + 0.5)
    w = int(W * grid / M + 0.5)
    fx, fy, cx, cy = np.asarray(intr, np.float32)
    sx, sy = w / W, h / H
    return (np.array([fx * sx, fy * sy, cx * sx, cy * sy], np.float32),
            h, w)


def render_features(trainer: Trainer, pose, intr, H: int, W: int,
                    grid: int = 64):
    """The rendered SAM features [h, w, 256] of a view through its
    low-res feature camera (`lowres_feature_camera`), with the live
    weights."""
    if getattr(trainer, "_feat_render", None) is None:
        trainer._feat_render = make_eval_render(trainer.model, trainer.cfg,
                                                return_feats=True)
    f_intr, fh, fw = lowres_feature_camera(intr, H, W, grid)
    out = trainer._feat_render(*_rays(trainer, pose, f_intr, fh, fw))
    return out["samvit"].reshape(fh, fw, -1)


# ---------------------------------------------------------------------------
# Stage 2: the SAM feature cache
# ---------------------------------------------------------------------------

def store_sam_features(trainer: Trainer, scene: Scene, sam_predictor,
                       out_dir: Optional[str] = None):
    """Render each of scene's views, encode the rendering with SAM's
    image encoder and save the features [g, g, 256] (g = img_size / 16)
    to sam_cache/{stem}.npy."""
    out_dir = out_dir or os.path.join(trainer.workspace, "sam_cache")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(scene.poses.shape[0]):
        out = trainer.render_view(scene.poses[i], _view_intrinsics(scene, i),
                                  scene.H, scene.W)
        rgb = (np.clip(out["image"].reshape(scene.H, scene.W, 3), 0, 1)
               * 255).astype(np.uint8)
        feats = sam_predictor.set_image(rgb)  # [1, g, g, 256]
        stem = os.path.splitext(str(scene.img_names[i]))[0]
        np.save(os.path.join(out_dir, stem + ".npy"),
                feats[0].cpu().numpy())
        trainer.log(f"[SAM-cache] {stem} saved")
    trainer.log(f"[INFO] stored SAM features to {out_dir}")


# ---------------------------------------------------------------------------
# Stage 2: the distill container
# ---------------------------------------------------------------------------

def evaluate_sam_features(trainer: Trainer, scene: Scene, sam_predictor,
                          max_views: Optional[int] = None,
                          save_dir: Optional[str] = None) -> float:
    """Stage-2 eval, the rendered features' MSE (JAX stages.py:71-130).  Per
    view: render the RGB (EMA weights) at a square online_resolution
    camera, fovy 60 or, with --use_default_focal_length, the view's own
    focal length (with --use_default_intrinsics the view's camera), encode
    it for the ground truth; render the feature map through the
    low-res feature camera at the encoder's grid (img_size / 16) and
    compare it with the ground truth's valid h x w block.  Logs an [EVAL
    stage-2] MSE line; save_dir gets {stem}_samvit.npy."""
    cfg = trainer.cfg
    grid = sam_predictor.img_size // 16
    meter = MSEMeter()
    n = scene.poses.shape[0] if max_views is None else min(
        max_views, scene.poses.shape[0])
    for i in range(n):
        intr = np.asarray(_view_intrinsics(scene, i), np.float32)
        H, W = scene.H, scene.W
        if not cfg.use_default_intrinsics:
            H = W = cfg.online_resolution
            focal = (float(intr[0]) if cfg.use_default_focal_length
                     else H / (2.0 * np.tan(0.5 * np.deg2rad(60.0))))
            intr = np.array([focal, focal, H / 2, W / 2], np.float32)
        out = trainer.render_view(scene.poses[i], intr, H, W)
        rgb = (np.clip(out["image"].reshape(H, W, 3), 0, 1)
               * 255).astype(np.uint8)
        gt = sam_predictor.set_image(rgb)[0]  # [grid, grid, 256]
        pred = render_features(trainer, scene.poses[i], intr, H, W, grid)
        fh, fw = pred.shape[:2]
        meter.update(pred.cpu(), gt[:fh, :fw].cpu())
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            stem = os.path.splitext(str(scene.img_names[i]))[0]
            np.save(os.path.join(save_dir, f"{stem}_samvit.npy"),
                    pred.cpu().numpy())
    trainer.log("[EVAL stage-2] " + meter.report())
    return meter.measure()


def make_render_and_encode(trainer: Trainer, sam, R: int,
                           img_size: int = 1024):
    """The distill container's ground truth without the host (JAX
    stages.py:131-170): `render_and_encode(rays_o, rays_d)` renders an
    R x R frame with the live weights, quantises it as round(rgb * 255)
    (the JAX device program's rounding; the host path truncates), resizes
    it to img_size^2 with jax.image.resize's bilinear, normalises it and
    runs SAM's image encoder.  Returns (features [g, g, 256], the first
    global block's output [g, g, C] or None)."""
    cfg = trainer.cfg
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps), use_contract=cfg.contract,
        min_near=cfg.min_near, background=cfg.background, bound=cfg.bound,
        max_ray_batch=cfg.max_ray_batch)
    dev = trainer.device
    mean = torch.tensor(PIXEL_MEAN, device=dev)
    std = torch.tensor(PIXEL_STD, device=dev)

    @torch.no_grad()
    def render_and_encode(rays_o, rays_d):
        out = render_staged(trainer.model, rays_o, rays_d, settings)
        img8 = torch.round(out["image"].clamp(0.0, 1.0).reshape(R, R, 3)
                           * 255.0)
        img = resize_bilinear(img8, (img_size, img_size, 3))
        feats, interm = sam.image_encoder(((img - mean) / std)[None],
                                          return_interm=True)
        return feats[0], (interm[0][0] if interm else None)

    return render_and_encode


def distill_batch(trainer: Trainer, pose, intr, sam_predictor,
                  render_and_encode=None, feat_hw: int = 64):
    """One encoded distill batch of a pose and an R x R camera intr [4]
    (R = online_resolution): the frame rendered with the live weights and
    encoded (through `render_and_encode` when given, else the host path:
    the image truncated to uint8, then `set_image`), and the low-res
    feature camera's rays (the intrinsics over R / feat_hw, feat_hw^2 rays).
    Returns {rays_o_lr, rays_d_lr, gt_samvit}."""
    R = trainer.cfg.online_resolution
    ro, rd = _rays(trainer, pose, intr, R, R)
    if render_and_encode is not None:
        gt, _ = render_and_encode(ro, rd)
    else:
        if getattr(trainer, "_live_render", None) is None:
            trainer._live_render = make_eval_render(trainer.model,
                                                    trainer.cfg)
        out = trainer._live_render(ro, rd)
        rgb = (out["image"].clamp(0, 1).reshape(R, R, 3) * 255).to(
            torch.uint8)
        gt = sam_predictor.set_image(rgb)[0]
    intr_lr = np.asarray(intr, np.float32) / np.float32(R / feat_hw)
    ro_lr, rd_lr = _rays(trainer, pose, intr_lr, feat_hw, feat_hw)
    return {"rays_o_lr": ro_lr, "rays_d_lr": rd_lr, "gt_samvit": gt}


def train_sam_distill(trainer: Trainer, scene: Scene, sam_predictor,
                      iters: Optional[int] = None, on_device: bool = False):
    """Distill container (JAX stages.py:172-242): each step renders a
    random training view at online_resolution with a random fovy in [50,
    70), encodes it (or, once the ring of cache_size batches is full, reuses
    a stored batch on every step but each cache_interval-th), and regresses
    the 64 x 64 rendered feature map onto the encoder's features.
    on_device takes `make_render_and_encode`'s path to the ground truth.
    The draws (view, fovy, the ring's pick, TV points) come from generators
    seeded from --seed and the step resumed at.  Checkpoints every iters /
    save_cnt steps and at the end."""
    cfg = trainer.cfg
    iters = iters or cfg.iters
    dev = trainer.device
    distill_step = make_sam_distill_step(
        trainer.model, cfg, frozen_backbone=trainer.backbone_frozen)
    step = step0 = trainer.state.step
    seed = cfg.seed * 1000003 + step
    host = torch.Generator().manual_seed(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    cache = (Cache(cfg.cache_size, torch.Generator().manual_seed(seed + 1))
             if cfg.cache_size > 0 else None)
    R = cfg.online_resolution
    render_and_encode = (make_render_and_encode(trainer, sam_predictor.sam, R,
                                                sam_predictor.img_size)
                         if on_device else None)
    save_every = max(iters // max(cfg.save_cnt, 1), 1)
    V = scene.poses.shape[0]
    trainer.stats["distill"] = []
    t_start = time.time()
    while step < iters:
        if (cache is not None and cache.full()
                and step % cfg.cache_interval != 0):
            batch = cache.get()
        else:
            vi = int(torch.randint(V, (), generator=host))
            batch = distill_batch(trainer, scene.poses[vi],
                                  sam_aug_intrinsics(host, R), sam_predictor,
                                  render_and_encode)
            if cache is not None:
                cache.insert(batch)
        metrics = distill_step(trainer.state, batch, gen)
        step += 1
        if step == step0 + 1 or step % 100 == 0 or step == iters:
            vals = {k: float(v) for k, v in metrics.items()}
            trainer.stats["distill"].append((step, vals))
            trainer.log(f"[SAM-distill {step}/{iters}] "
                        f"loss={vals['loss']:.5f}")
        if step % save_every == 0:
            trainer.ckpt.save(step, trainer.state.state_dict())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t_start
    trainer.log(f"[INFO] distill training took {dt / 60:.2f} min "
                f"({(step - step0) / max(dt, 1e-9):.1f} steps/s)")
    if step == step0 or step % save_every:  # not saved at this step yet
        trainer.ckpt.save(step, trainer.state.state_dict())


# ---------------------------------------------------------------------------
# Decode: 3-D point prompts -> per-view masks
# ---------------------------------------------------------------------------

def decode(trainer: Trainer, scene: Scene, sam_predictor,
           prompts: PointPrompts, out_dir: Optional[str] = None,
           feature_container: str = "cache", depth_tol: float = 0.05):
    """Per view: render RGB and depth, read the cached features (cache) or
    render them through the view's low-res feature camera (distill; an
    aspect-preserving h x w map that `set_features` pads), project the 3-D
    prompts with the depth gate, decode them with SAM and keep the mask of
    the best IoU score.  Writes {stem}_rgb.png (the rendering with
    the mask and points overlaid), {stem}_depth.npy, {stem}_obj_mask.npy
    ([1, H, W] uint8) and valid_dict.json ({stem: 0 or 1}) to out_dir
    (default <workspace>/object_masks)."""
    import json

    if feature_container not in ("cache", "distill"):
        raise ValueError(f"unknown feature_container {feature_container}")
    out_dir = out_dir or os.path.join(trainer.workspace, "object_masks")
    os.makedirs(out_dir, exist_ok=True)
    valid_dict = {}
    H, W = scene.H, scene.W
    for i in range(scene.poses.shape[0]):
        stem = os.path.splitext(str(scene.img_names[i]))[0]
        intr = _view_intrinsics(scene, i)
        out = trainer.render_view(scene.poses[i], intr, H, W)
        rgb = out["image"].reshape(H, W, 3)
        depth = out["depth"].reshape(H, W)
        if feature_container == "cache":
            feats = np.load(os.path.join(trainer.workspace, "sam_cache",
                                         stem + ".npy"))
            if feats.ndim == 3 and feats.shape[0] == 256:
                feats = feats.transpose(1, 2, 0)  # the legacy [256, h, w]
        else:
            feats = render_features(trainer, scene.poses[i], intr, H, W)
        gate_info: dict = {}
        coords, labels, _, is_valid = project_points_to_view(
            prompts, scene.poses[i], np.asarray(intr), H, W,
            pred_depth=depth, depth_tol=depth_tol, info=gate_info)
        if coords is not None:
            sam_predictor.set_features(feats, original_size=(H, W))
            masks, scores, _ = sam_predictor.predict(
                point_coords=sam_predictor.transform_coords(coords),
                point_labels=labels, multimask_output=True)
            pred_mask = masks[int(np.argmax(scores))]
            vis = overlay_point(overlay_mask(rgb, pred_mask), coords,
                                inputs_point_labels=labels)
        else:
            pred_mask = np.zeros((H, W), bool)
            vis = rgb
            is_valid = False
        _save_image(os.path.join(out_dir, f"{stem}_rgb.png"), vis)
        np.save(os.path.join(out_dir, f"{stem}_depth.npy"), depth)
        np.save(os.path.join(out_dir, f"{stem}_obj_mask.npy"),
                pred_mask.astype(np.uint8)[None])
        valid_dict[stem] = int(bool(is_valid))
        err = gate_info.get("depth_err")
        err_s = (f" gate|z-depth| min={err.min():.3f} max={err.max():.3f}"
                 f" tol={depth_tol}" if err is not None and err.size else "")
        trainer.log(f"[decode] {stem} valid={is_valid}{err_s}")
    with open(os.path.join(out_dir, "valid_dict.json"), "w") as f:
        json.dump(valid_dict, f, indent=2)
    trainer.log(f"[INFO] decode outputs saved to {out_dir}")
    return out_dir


# ---------------------------------------------------------------------------
# Stage 3: the object field
# ---------------------------------------------------------------------------

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
    out = trainer._mask_render(*_rays(trainer, pose, intrinsics, H, W))
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
