"""Proposal-network volume renderer, inference and training.

Fixed per-ray sample counts (default 128, 64, 32).  Two routes:
  - the level-kernel route: both proposal levels through K5 (proposal MLP,
    compositing and inverse-CDF resampling in one kernel) and the final
    level through K3 (trunk with CP features and compositing in one
    kernel).  Training runs K1 (K5 that also returns the weights) and K3
    as autograd Functions whose backward passes are K2 and K4.  With the
    stage-3 mask output (`return_mask`) the backbone runs through K5 and
    K6 (K3 that also returns each sample's trunk features) with no
    gradient: at inference, and in training when `frozen_backbone` says
    the optimizer freezes it; only the mask branch is differentiable;
  - the composable route: per-sample densities and colours from the
    field's `density` / `forward_color`, `compute_weights`, `sample_pdf`
    (its lookup K10), and autograd through them.  On the MLP field the
    proposal MLPs and, without CP features, the trunk run K8 (freq encode
    + MLP forward, backward through the plain version); the rest is plain
    PyTorch.  It is the oracle for the level kernels, the route of fields
    without level kernels, and, as in JAX, the route of a stage-2 or -3
    training render whose backbone is not frozen (`return_feats` or
    `return_mask` without `frozen_backbone`).
`update_proposal` is a Python bool or, as JAX's traced form, a 0-d bool
tensor.  A Python False detaches the proposal weights and the proposal
loss is 0 (the reference's cadence, step <= 3000 or step % 5 == 0, picks it
per step); a tensor leaves the forward as it is and gates the proposal
grads with torch.where(upd, x, x.detach()), the proposal loss multiplied
by upd, on either route (on the level-kernel route the gate sits on K1's
weights, so K2 runs with a zero cotangent under False).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models.fields import GEOM_FEAT_DIM, SH_DEGREE
from ..ops.composite import compute_weights, distort_loss, proposal_loss
from ..ops.contraction import contract
from ..ops.ray import (near_far_from_aabb, sample_pdf, spacing_fn,
                       spacing_fn_inv, stratified_queries, uniform_rows)
from ..ops.sh import sh_encode
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    num_steps: Tuple[int, ...] = (128, 64, 32)
    use_contract: bool = True
    min_near: float = 0.2
    background: str = "last_sample"  # white | random | last_sample
    bound: float = 128.0  # world-space aabb half-edge
    perturb: bool = False
    training: bool = False
    compute_losses: bool = False  # proposal + distortion losses
    max_ray_batch: int = 16384
    # False forces the composable route (the oracle the kernels are held to)
    level_kernels: bool = True
    # stage-2 SAM features ('samvit' [N, 256]); with the view direction the
    # SAM MLP reads the whole composited f_image, else its trunk features
    return_feats: bool = False
    sam_use_view_direction: bool = False
    # stage-3 object-field logits ('instance_mask_logits' [N, n_inst])
    return_mask: bool = False
    # the optimizer freezes the backbone (stages 2 and 3), so a training
    # render with a side output may run it through the gradient-free K5
    # and K6
    frozen_backbone: bool = False


def render_rays(field, rays_o, rays_d, settings: RenderSettings,
                generator: Optional[torch.Generator] = None, bg_color=1.0,
                cam_near_far=None, aabb=None, update_proposal=True,
                rows: Optional[Tuple[int, int]] = None):
    """Render a batch of rays.  rays_o, rays_d: [N, 3] float32 (rays_d
    unnormalised, so depth is z-distance).  `generator` jitters the samples
    when settings.perturb; rows=(start, total) says the batch is rows
    start.. of a batch of `total` rays (a data-parallel shard) whose
    jitter is drawn whole (ops/ray.py uniform_rows).  Returns {'image'
    [N, 3], 'depth' [N], 'weights_sum' [N]}; training adds 'weights' [N, T]
    (final level) and 'num_points', and with compute_losses
    'proposal_loss' and 'distort_loss'; return_feats adds 'samvit',
    return_mask 'instance_mask_logits'."""
    with span("sanerf.render"):
        return _render_rays(field, rays_o, rays_d, settings, generator,
                            bg_color, cam_near_far, aabb, update_proposal,
                            rows)


def _render_rays(field, rays_o, rays_d, settings, generator, bg_color,
                 cam_near_far, aabb, update_proposal, rows):
    N, dev = rays_o.shape[0], rays_o.device
    n_levels = len(settings.num_steps)
    training = settings.training
    gen = generator if settings.perturb else None
    if aabb is None:
        b = settings.bound
        aabb = torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32,
                            device=dev)

    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, settings.min_near)
    if cam_near_far is not None:
        nears = torch.maximum(nears, cam_near_far[:, :1])
        fars = torch.minimum(fars, cam_near_far[:, 1:2])
    s_nears, s_fars = spacing_fn(nears), spacing_fn(fars)

    static_upd = isinstance(update_proposal, bool)
    if static_upd:
        def gate(x):  # proposal grads flow only on update_proposal steps
            return x if update_proposal else x.detach()
    else:
        upd = torch.as_tensor(update_proposal, device=dev).reshape(())

        def gate(x):  # the forward as it is, grads where upd
            return torch.where(upd, x, x.detach())

    opaque = settings.background == "last_sample"
    kernels = settings.level_kernels and getattr(
        field, "supports_fused_final", False)
    # the JAX renderer's routing (renderer.py:130-147): the stage-1 kernels
    # without side outputs, the frozen-backbone kernels with one
    side_outputs = settings.return_feats or settings.return_mask
    fused = kernels and not side_outputs
    frozen = (kernels and side_outputs
              and not settings.compute_losses
              and (not training or settings.frozen_backbone))
    bins = weights = rays_t = colors = fused_out = folded = None
    geo_feat = xyzs_final = None
    all_bins, all_weights = [], []

    def level_bins(level, T):
        """The level's edges in [0, 1] (from the level before: its weights,
        or the edges its kernel folded) and on the ray."""
        if level == 0:
            b = torch.linspace(0.0, 1.0, T + 1, device=dev).expand(N, T + 1)
            if gen is not None:
                b = (b + (uniform_rows(N, T + 1, dev, gen, rows)
                          - 0.5) / T).clamp(0, 1)
            b = b.contiguous()
        elif folded is not None:
            b = folded
        else:
            b = sample_pdf(bins, weights.detach(), T + 1, generator=gen,
                           rows=rows)
        return b, spacing_fn_inv(s_nears * (1.0 - b) + s_fars * b)

    def sample_points(real_bins):
        rays_t = (real_bins[..., 1:] + real_bins[..., :-1]) / 2.0  # [N, T]
        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * rays_t[..., None]
        return rays_t, (contract(xyzs) if settings.use_contract else xyzs)

    for level, T in enumerate(settings.num_steps[:-1]):
        with span("sanerf.render.proposal"):
            bins, real_bins = level_bins(level, T)
            folded = None
            if fused or frozen:
                # next level's s-space edges straight from the proposal
                # kernel; in inference the per-sample weights never reach
                # device memory
                u = stratified_queries(N, settings.num_steps[level + 1] + 1,
                                       dev, gen, rows).contiguous()
                if training and not frozen:
                    weights, folded = field.fused_prop_weights_train_sample(
                        rays_o, rays_d, real_bins, bins, u, proposal=level,
                        opaque_last=opaque)
                    all_bins.append(bins)
                    all_weights.append(gate(weights))
                else:
                    folded = field.fused_prop_next_bins(
                        rays_o, rays_d, real_bins, bins, u, proposal=level,
                        opaque_last=opaque, frozen=frozen)
                continue
            _, xyzs = sample_points(real_bins)
            sigmas = gate(field.density(xyzs, proposal=level))
            deltas = real_bins[..., 1:] - real_bins[..., :-1]
            weights, _ = compute_weights(deltas, sigmas, opaque_last=opaque)
            if training:
                all_bins.append(bins)
                all_weights.append(weights)

    with span("sanerf.render.final"):
        bins, real_bins = level_bins(n_levels - 1, settings.num_steps[-1])
        if frozen:
            *fused_out, weights, geo_feat = field.fused_final_render_frozen(
                rays_o, rays_d, real_bins, opaque_last=opaque,
                need_geo=settings.return_mask)
            rays_t, xyzs_final = sample_points(real_bins)
            xyzs_final = xyzs_final.detach()
        elif fused and training:
            *fused_out, weights = field.fused_final_render_train(
                rays_o, rays_d, real_bins, opaque_last=opaque)
            all_bins.append(bins)
            all_weights.append(weights)
        elif fused:
            fused_out = field.fused_final_render(
                rays_o, rays_d, real_bins, opaque_last=opaque)
        else:
            rays_t, xyzs_final = sample_points(real_bins)
            dirs = rays_d[:, None, :].expand(xyzs_final.shape)
            dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
            sigmas, geo_feat, colors, _ = field.forward_color(xyzs_final,
                                                              dirs)
            deltas = real_bins[..., 1:] - real_bins[..., :-1]
            weights, _ = compute_weights(deltas, sigmas, opaque_last=opaque)
            if training:
                all_bins.append(bins)
                all_weights.append(weights)
        if fused_out is not None:
            f_image, depth, weights_sum = fused_out
        else:
            weights_sum = weights.sum(dim=-1)
            depth = (weights * rays_t).sum(dim=-1)
            f_image = (weights[..., None] * colors).sum(dim=-2)  # [N, 31]
        image = torch.sigmoid(field.apply_view_mlp(f_image))
        results = {}
        if training:
            results["num_points"] = N * settings.num_steps[-1]
            results["weights"] = weights
            if settings.compute_losses:
                if static_upd:
                    results["proposal_loss"] = (
                        proposal_loss(all_bins, all_weights) if update_proposal
                        else torch.zeros((), device=dev))
                else:
                    results["proposal_loss"] = (
                        proposal_loss(all_bins, all_weights) * upd.float())
                results["distort_loss"] = distort_loss(bins, weights)
        image = image + (1.0 - weights_sum)[..., None] * bg_color
        results.update(weights_sum=weights_sum, depth=depth, image=image)

        if settings.return_feats:
            # SAM feature branch (JAX renderer.py:290-306)
            features = field.sam_features(xyzs_final)  # [N, T, C]
            f_sam = (weights[..., None] * features).sum(dim=-2)
            if settings.sam_use_view_direction:
                f = torch.cat([f_sam, f_image, image, depth[..., None]],
                              dim=-1)
            else:
                # on the frozen route without the trunk features the kernel
                # has composited them: f_image[:, :15] is sum_s w_s geo_s
                geo_sum = (f_image[..., :GEOM_FEAT_DIM] if geo_feat is None
                           else (weights[..., None] * geo_feat).sum(dim=-2))
                f = torch.cat([f_sam, geo_sum, image, depth[..., None]],
                              dim=-1)
            results["samvit"] = field.apply_samvit_mlp(f)  # [N, 256]

        if settings.return_mask:
            # object-field branch: the mask MLP on per-sample features,
            # composited with detached weights (JAX renderer.py:308-333)
            masks = field.mask_features(xyzs_final)  # [N, T, C]
            if field.mask_mlp_type == "default":
                m = torch.cat([masks, geo_feat.detach()], dim=-1)
            else:
                if colors is None:
                    # frozen route: rebuild the per-sample colours [geo | sh]
                    # (sh is per ray)
                    dn = rays_d / torch.linalg.norm(rays_d, dim=-1,
                                                    keepdim=True)
                    sh = sh_encode(dn, SH_DEGREE)
                    colors = torch.cat(
                        [geo_feat,
                         sh[:, None, :].expand(*geo_feat.shape[:2], -1)],
                        dim=-1)
                m = torch.cat([masks, colors.detach()], dim=-1)
            point_masks = field.apply_mask_mlp(m)  # [N, T, n_inst]
            results["instance_mask_logits"] = (
                weights.detach()[..., None] * point_masks).sum(dim=-2)
        return results


def render_staged(field, rays_o, rays_d, settings: RenderSettings,
                  bg_color=1.0, cam_near_far=None, aabb=None,
                  generator: Optional[torch.Generator] = None):
    """Chunked full-frame inference: render_rays over chunks of
    settings.max_ray_batch rays.  cam_near_far is per ray [N, 2] or shared
    [1, 2]."""
    N = rays_o.shape[0]
    chunk = settings.max_ray_batch
    per_ray = cam_near_far is not None and cam_near_far.shape[0] == N
    outs = []
    for i in range(0, N, chunk):
        nf = cam_near_far[i:i + chunk] if per_ray else cam_near_far
        with span("sanerf.view.chunk"):
            outs.append(render_rays(field, rays_o[i:i + chunk],
                                    rays_d[i:i + chunk], settings,
                                    generator=generator, bg_color=bg_color,
                                    cam_near_far=nf, aabb=aabb))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
