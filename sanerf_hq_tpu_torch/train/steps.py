"""Render functions built from a Config (the training steps come with the
training slice)."""
from __future__ import annotations

import torch

from ..config import Config
from ..render.renderer import RenderSettings, render_staged


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
