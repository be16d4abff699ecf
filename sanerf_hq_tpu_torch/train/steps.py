"""Render and train-step functions built from a Config.

The stage-1 RGB step: MSE + lambda_proposal * interlevel proposal loss +
lambda_distort * distortion loss (ramped in over [w, 2w] steps with
w = lambda_distort_warmup) + lambda_entropy * binary entropy of
weights_sum.  The proposal MLPs get grads on the reference's cadence,
step <= 3000 or step % 5 == 0, step counted before the update.
"""
from __future__ import annotations

import torch

from ..config import Config
from ..render.renderer import RenderSettings, render_rays, render_staged


def make_eval_render(model, cfg: Config, perturb: bool = False):
    """Staged full-frame render for eval/test (chunked; deterministic unless
    perturb=True and a generator is passed)."""
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps),
        use_contract=cfg.contract,
        min_near=cfg.min_near,
        background=cfg.background,
        bound=cfg.bound,
        perturb=perturb,
        training=False,
        max_ray_batch=cfg.max_ray_batch,
    )

    @torch.inference_mode()
    def eval_render(rays_o, rays_d, bg_color=1.0, cam_near_far=None,
                    aabb=None, generator=None):
        return render_staged(model, rays_o, rays_d, settings,
                             bg_color=bg_color, cam_near_far=cam_near_far,
                             aabb=aabb, generator=generator)

    return eval_render


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
