"""Render and train-step functions built from a Config.

The stage-1 RGB step: MSE + lambda_proposal * interlevel proposal loss +
lambda_distort * distortion loss (ramped in over [w, 2w] steps with
w = lambda_distort_warmup) + lambda_entropy * binary entropy of
weights_sum + lambda_tv * total variation + lambda_wd * weight decay of the
hash-grid field's main table.  The proposal MLPs get grads on the
reference's cadence, step <= 3000 or step % 5 == 0, step counted before
the update.

The stage-3 mask step: cross-entropy of the object-field logits over the
labelled global rays, + label_regularization_weight * the depth-weighted
smoothness of the patch logits, + ray_pair_rgb_loss_weight * the ray-pair
RGB loss on the patches once step > ray_pair_rgb_iter; it also returns
the error map with the global rays' cells moved to 0.1 old + 0.9 error.

The stage-2 distill step: the MSE of the rendered 64 x 64 SAM feature map
(resized to the encoder's grid where the two differ) against the
encoder's features of a full rendering, + lambda_tv * total variation +
lambda_wd * weight decay of the hash-grid field's s_grid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config
from ..models.fields import active_reg_grid
from ..ops.hashgrid import (total_variation_loss, total_variation_loss_at,
                            weight_decay_loss)
from ..render.renderer import RenderSettings, render_rays, render_staged
from ..utils.resize import resize_bilinear


def make_eval_render(model, cfg: Config, perturb: bool = False,
                     return_mask: bool = False, return_feats: bool = False):
    """Staged full-frame render for eval/test (chunked; deterministic unless
    perturb=True and a generator is passed); return_mask adds the object
    field's 'instance_mask_logits', return_feats the SAM features
    'samvit'."""
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps),
        use_contract=cfg.contract,
        min_near=cfg.min_near,
        background=cfg.background,
        bound=cfg.bound,
        perturb=perturb,
        training=False,
        max_ray_batch=cfg.max_ray_batch,
        return_mask=return_mask,
        return_feats=return_feats,
        sam_use_view_direction=cfg.sam_use_view_direction,
    )

    @torch.inference_mode()
    def eval_render(rays_o, rays_d, bg_color=1.0, cam_near_far=None,
                    aabb=None, generator=None):
        return render_staged(model, rays_o, rays_d, settings,
                             bg_color=bg_color, cam_near_far=cam_near_far,
                             aabb=aabb, generator=generator)

    return eval_render


def _grid_regularizers(model, cfg: Config, stage: str):
    """The --lambda_tv / --lambda_wd term of a stage's loss on its hash
    table ('rgb': grid, 'sam': s_grid, 'mask': m_grid), a function of a
    generator (TV draws its points from it) or of the TV points themselves
    (unit-cube [n, 3]); None when both lambdas are 0 or the model has no
    table for the stage (the MLP field)."""
    if cfg.lambda_tv <= 0 and cfg.lambda_wd <= 0:
        return None
    reg = active_reg_grid(model, stage)
    if reg is None:
        return None
    name, spec = reg

    def reg_loss(generator=None, tv_points=None):
        table = getattr(model, name)
        loss = 0.0
        if cfg.lambda_tv > 0:
            tv = (total_variation_loss(table, spec, generator)
                  if tv_points is None
                  else total_variation_loss_at(table, spec, tv_points))
            loss = loss + cfg.lambda_tv * tv
        if cfg.lambda_wd > 0:
            loss = loss + cfg.lambda_wd * weight_decay_loss(table, spec)
        return loss

    return reg_loss


def update_proposal_at(step: int) -> bool:
    return step <= 3000 or step % 5 == 0


def make_rgb_train_step(model, cfg: Config, perturb: bool = True,
                        level_kernels: bool = True):
    """Stage-1 RGB step.  `train_step(state, batch, generator)` with batch
    {rays_o, rays_d [N, 3], gt_rgb [N, 3 or 4], optional cam_near_far}
    computes the loss at state.step, backpropagates, applies one Adam
    update and returns the detached metrics {mse, [proposal_loss],
    [distort_loss], loss, psnr}.  `generator` jitters the samples
    (perturb=False renders without jitter) and draws the random
    background.  `train_step.loss_fn(batch, step, update_proposal,
    generator)` is the loss alone, for grad checks."""
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps),
        use_contract=cfg.contract,
        min_near=cfg.min_near,
        background=cfg.background,
        bound=cfg.bound,
        perturb=perturb,
        training=True,
        compute_losses=(cfg.lambda_proposal > 0 or cfg.lambda_distort > 0),
        level_kernels=level_kernels,
    )
    reg_loss = _grid_regularizers(model, cfg, "rgb")

    def loss_fn(batch, step: int, update_proposal: bool, generator=None):
        images = batch["gt_rgb"]
        if cfg.background == "random":
            bg_color = torch.rand((images.shape[0], 3), generator=generator,
                                  device=images.device)
        else:
            bg_color = 1.0
        if images.shape[-1] == 4:
            gt_rgb = (images[..., :3] * images[..., 3:]
                      + bg_color * (1.0 - images[..., 3:]))
        else:
            gt_rgb = images
        out = render_rays(model, batch["rays_o"], batch["rays_d"], settings,
                          generator=generator, bg_color=bg_color,
                          cam_near_far=batch.get("cam_near_far"),
                          update_proposal=update_proposal)
        loss = torch.mean((out["image"] - gt_rgb) ** 2)
        metrics = {"mse": loss}
        if cfg.lambda_proposal > 0:
            loss = loss + cfg.lambda_proposal * out["proposal_loss"]
            metrics["proposal_loss"] = out["proposal_loss"]
        if cfg.lambda_distort > 0:
            lam = cfg.lambda_distort
            w = cfg.lambda_distort_warmup
            if w > 0:
                lam = lam * min(max((step - w) / w, 0.0), 1.0)
            loss = loss + lam * out["distort_loss"]
            metrics["distort_loss"] = out["distort_loss"]
        if cfg.lambda_entropy > 0:
            ws = out["weights_sum"].clamp(1e-5, 1 - 1e-5)
            entropy = -ws * torch.log2(ws) - (1 - ws) * torch.log2(1 - ws)
            loss = loss + cfg.lambda_entropy * entropy.mean()
        if reg_loss is not None:
            loss = loss + reg_loss(generator)
        metrics["loss"] = loss
        metrics["psnr"] = -10.0 * torch.log10(metrics["mse"].clamp_min(1e-10))
        return loss, metrics

    def train_step(state, batch, generator=None):
        loss, metrics = loss_fn(batch, state.step,
                                update_proposal_at(state.step), generator)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    train_step.loss_fn = loss_fn
    return train_step


def _cosine_similarity(a, b, dim: int = -1, eps: float = 1e-8):
    na = torch.linalg.norm(a, dim=dim)
    nb = torch.linalg.norm(b, dim=dim)
    return (a * b).sum(dim=dim) / torch.clamp(na * nb, min=eps)


def ray_pair_rgb_loss(generator, rgb, inst_masks, incoherent, cfg: Config,
                      use_pred_logistics: bool = False):
    """Ray-pair RGB loss on local patches (JAX steps.py:232-268).

    rgb / inst_masks [P, S, C] per patch; incoherent [P, S] error-map
    values.  ray_pair_rgb_num_sample anchors a patch are drawn without
    replacement (Gumbel top-k) among its coherent rays (1 - err > 0.8), or
    among all rays when none is coherent; every ray whose colour lies
    within ray_pair_rgb_threshold of an anchor is pushed toward the
    anchor's argmax one-hot mask (its probabilities with
    use_pred_logistics) through exp(-w * cos_sim)."""
    P, S, _ = rgb.shape
    ns = cfg.ray_pair_rgb_num_sample
    weights = (1.0 - incoherent > 0.8).float()
    invalid = weights.sum(dim=-1, keepdim=True) == 0
    weights = torch.where(invalid, 1.0, weights)
    # log w + Gumbel noise, the noise as -log of an Exp(1) draw
    e = torch.empty((P, S), device=rgb.device).exponential_(
        generator=generator)
    idx = torch.topk(torch.log(weights.clamp_min(1e-12)) - torch.log(e), ns,
                     dim=-1).indices  # [P, ns]

    def take(arr):
        return torch.gather(arr, 1, idx[..., None].expand(-1, -1,
                                                          arr.shape[-1]))

    rgb_s = take(rgb)[:, :, None, :]  # [P, ns, 1, 3]
    mask_s = take(inst_masks).detach()[:, :, None, :]
    if not use_pred_logistics:
        arg = mask_s.argmax(dim=-1, keepdim=True)
        mask_s = (torch.arange(mask_s.shape[-1], device=arg.device)
                  == arg).to(mask_s.dtype)
    color_dist = torch.linalg.norm(rgb[:, None] - rgb_s, dim=-1)  # [P, ns, S]
    similar = (color_dist < cfg.ray_pair_rgb_threshold).float()
    cos = _cosine_similarity(inst_masks[:, None], mask_s)  # [P, ns, S]
    pred_sim = torch.exp(-cfg.ray_pair_rgb_exp_weight * cos - cfg.epsilon)
    num = (similar * pred_sim).sum(dim=-1)
    den = similar.sum(dim=-1).clamp_min(1.0)
    return (num / den).mean()


def label_regularization(depth, pred_masks, patch_size: int, n_inst: int):
    """Depth-weighted spatial smoothness of the patch logits (JAX
    steps.py:271-287): depth [P*S], pred_masks [P*S, n_inst]."""
    pm = pred_masks.reshape(-1, patch_size, patch_size, n_inst)
    d = depth.reshape(-1, patch_size, patch_size)
    diff_x = pm[:, :, 1:] - pm[:, :, :-1]
    diff_y = pm[:, 1:, :] - pm[:, :-1, :]
    ddx = d[:, :, 1:] - d[:, :, :-1]
    ddy = d[:, 1:, :] - d[:, :-1, :]
    wx = torch.exp(-(ddx * ddx))[..., None].expand(diff_x.shape)
    wy = torch.exp(-(ddy * ddy))[..., None].expand(diff_y.shape)
    return ((diff_x ** 2 * wx).sum() / wx.sum()
            + (diff_y ** 2 * wy).sum() / wy.sum())


def mask_losses(out, batch, step: int, error_map, cfg: Config,
                generator=None):
    """The stage-3 loss of a rendered batch (JAX steps.py:321-382).  out:
    render_rays' {instance_mask_logits, image, depth} for the batch's
    Ng = cfg.num_rays global rays, then its local patch rays.  Returns
    (loss, metrics {ce, [label_reg], [ray_pair], loss, acc}, the error map
    with the global rays' cells moved to 0.1 old + 0.9 error, a new
    tensor)."""
    Ng = cfg.num_rays
    P, S = cfg.num_local_sample, cfg.local_sample_patch_size ** 2
    eps = cfg.epsilon
    probs = torch.softmax(out["instance_mask_logits"], dim=-1).clamp(
        eps, 1 - eps)
    gt = batch["gt_masks"][:Ng]
    labeled = (gt != -1).float()
    n_labeled = labeled.sum().clamp_min(1.0)
    safe_gt = gt.clamp_min(0)
    picked = probs[:Ng].gather(1, safe_gt[:, None])[:, 0]
    loss = (-torch.log(picked) * labeled).sum() / n_labeled

    onehot = F.one_hot(safe_gt, probs.shape[-1]).float()
    cos = _cosine_similarity(probs[:Ng].detach(), onehot)
    err = torch.exp(-cfg.ray_pair_rgb_exp_weight * cos - eps)
    cell = (batch["img_inds"], batch["inds_coarse"])
    new_map = error_map.clone()
    new_map[cell] = 0.1 * error_map[cell] + 0.9 * err

    metrics = {"ce": loss}
    if cfg.label_regularization_weight > 0:
        lr_loss = label_regularization(
            out["depth"][Ng:].detach(), probs[Ng:],
            cfg.local_sample_patch_size, probs.shape[-1])
        loss = loss + cfg.label_regularization_weight * lr_loss
        metrics["label_reg"] = lr_loss
    if cfg.ray_pair_rgb_loss_weight > 0 and P * S > 0:
        rp = ray_pair_rgb_loss(
            generator, out["image"][Ng:].detach().reshape(P, S, -1),
            probs[Ng:].reshape(P, S, -1), batch["local_error"].reshape(P, S),
            cfg, use_pred_logistics=cfg.ray_pair_rgb_use_pred_logistics)
        gate = float(step > cfg.ray_pair_rgb_iter)
        loss = loss + cfg.ray_pair_rgb_loss_weight * gate * rp
        metrics["ray_pair"] = rp
    metrics["loss"] = loss
    hit = (probs[:Ng].argmax(dim=-1) == gt).float()
    metrics["acc"] = (hit * labeled).sum() / n_labeled
    return loss, metrics, new_map


def make_mask_train_step(model, cfg: Config, frozen_backbone: bool = False):
    """Stage-3 object-field step (JAX steps.py:290-392).

    `mask_step(state, batch, generator, error_map)` with batch {rays_o,
    rays_d [Ng+Nl, 3] (global rays, then the local patches' rays),
    gt_masks [Ng+Nl] (-1 unlabelled), img_inds, inds_coarse [Ng] (view
    and error-map cell of each global ray), local_error [Nl]} renders the
    batch, computes `mask_losses` at state.step, backpropagates, applies
    one Adam update and returns (detached metrics, the updated error map
    [V, S*S]).  `generator` draws the ray-pair anchors and the TV points
    of --lambda_tv.  frozen_backbone renders the backbone through K5 and
    K6 on the MLP field (the trainer freezes every backbone parameter).
    `mask_step.loss_fn(batch, step, error_map, generator, tv_points)`
    returns (loss, metrics, error map); tv_points [n, 3] in the unit cube
    replace the drawn TV points."""
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps),
        use_contract=cfg.contract,
        min_near=cfg.min_near,
        background=cfg.background,
        bound=cfg.bound,
        perturb=False,
        training=True,
        compute_losses=False,
        return_mask=True,
        frozen_backbone=frozen_backbone,
    )
    reg_loss = _grid_regularizers(model, cfg, "mask")

    def loss_fn(batch, step: int, error_map, generator=None, tv_points=None):
        out = render_rays(model, batch["rays_o"], batch["rays_d"], settings,
                          cam_near_far=batch.get("cam_near_far"),
                          update_proposal=False)
        loss, metrics, new_map = mask_losses(out, batch, step, error_map, cfg,
                                             generator)
        if reg_loss is not None:
            loss = loss + reg_loss(generator, tv_points)
            metrics["loss"] = loss
        return loss, metrics, new_map

    def mask_step(state, batch, generator, error_map):
        loss, metrics, new_map = loss_fn(batch, state.step, error_map,
                                         generator)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}, new_map

    mask_step.loss_fn = loss_fn
    return mask_step


def make_sam_distill_step(model, cfg: Config, feat_hw: int = 64,
                          frozen_backbone: bool = False):
    """Stage-2 distill step (JAX steps.py:173-225).

    `distill_step(state, batch, generator)` with batch {rays_o_lr,
    rays_d_lr [feat_hw^2, 3] (the low-res feature camera's rays, row-
    major), gt_samvit [gh, gw, 256] (the encoder's features), optional
    cam_near_far} renders the feature map without jitter, computes the
    loss, backpropagates, applies one Adam update and returns the detached
    metrics {loss, mse}.  The map [feat_hw, feat_hw, 256] is resized to
    [gh, gw] (jax.image.resize's bilinear) when the grids differ.
    `generator` (on the model's device) draws the TV points of
    --lambda_tv.  frozen_backbone renders the backbone through K5 and K6
    on the MLP field (the trainer freezes every backbone parameter).
    `distill_step.loss_fn(batch, generator, tv_points)` returns (loss,
    metrics, the render's outputs); tv_points [n, 3] in the unit cube
    replace the drawn TV points."""
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps),
        use_contract=cfg.contract,
        min_near=cfg.min_near,
        background=cfg.background,
        bound=cfg.bound,
        perturb=False,
        training=True,
        compute_losses=False,
        return_feats=True,
        sam_use_view_direction=cfg.sam_use_view_direction,
        frozen_backbone=frozen_backbone,
    )
    reg_loss = _grid_regularizers(model, cfg, "sam")

    def loss_fn(batch, generator=None, tv_points=None):
        out = render_rays(model, batch["rays_o_lr"], batch["rays_d_lr"],
                          settings, cam_near_far=batch.get("cam_near_far"),
                          update_proposal=False)
        pred = out["samvit"].reshape(feat_hw, feat_hw, -1)
        gt = batch["gt_samvit"]
        if pred.shape[:2] != gt.shape[:2]:
            pred = resize_bilinear(pred, (*gt.shape[:2], pred.shape[-1]))
        mse = torch.mean((pred - gt) ** 2)
        loss = mse
        if reg_loss is not None:
            loss = loss + reg_loss(generator, tv_points)
        return loss, {"loss": loss, "mse": mse}, out

    def distill_step(state, batch, generator=None):
        loss, metrics, _ = loss_fn(batch, generator)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    distill_step.loss_fn = loss_fn
    return distill_step
