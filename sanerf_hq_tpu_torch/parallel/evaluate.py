"""Sharded evaluation: each rank renders its slice of the rays and the
results meet in collectives (the JAX package's shard_map with psum and a
gather on the ray axis; parallel/mesh.py says how the port's ranks differ
from JAX's devices)."""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..render.renderer import RenderSettings, render_rays, render_staged
from .mesh import Mesh, world_size


def _gather(x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def make_sharded_eval_step(model, settings: RenderSettings, mesh: Mesh,
                           axis: str = "data"):
    """eval_step(rays_o, rays_d, gt_rgb) -> {mse, psnr, image}: this rank
    renders rows r*N/W.. of the N rays (N divisible by the axis size W),
    the squared error and the element count are summed over the ranks
    before the MSE, and the image is gathered on the ray axis."""
    w = mesh.shape[axis]
    r = mesh.coords[axis]

    @torch.inference_mode()
    def eval_step(rays_o, rays_d, gt_rgb):
        N = rays_o.shape[0]
        if N % w:
            raise ValueError(f"{N} rays do not divide over {w} ranks")
        sl = slice(r * (N // w), (r + 1) * (N // w))
        pred = render_rays(model, rays_o[sl], rays_d[sl], settings,
                           bg_color=1.0)["image"]
        se = ((pred - gt_rgb[sl, :3]) ** 2).sum()
        sums = torch.stack([se, torch.tensor(float(pred.numel()),
                                             device=se.device)])
        dist.all_reduce(sums)
        mse = sums[0] / sums[1]
        return {"mse": mse,
                "psnr": -10.0 * torch.log10(mse.clamp_min(1e-10)),
                "image": _gather(pred)}

    return eval_step


def make_sharded_render(model, settings: RenderSettings, mesh: Mesh,
                        axis: str = "data"):
    """render(rays_o, rays_d, bg_color=1.0, cam_near_far=None, aabb=None,
    generator=None) with render_staged's outputs: the rays padded to a
    multiple of the axis size W (rays_o zeros, rays_d ones), this rank
    rendering its contiguous slice through render_staged, the outputs
    gathered on the ray axis and trimmed to N.  cam_near_far is a shared
    [1, 2].  Deterministic only: generator must be None."""
    w = mesh.shape[axis]
    r = mesh.coords[axis]

    @torch.inference_mode()
    def render(rays_o, rays_d, bg_color=1.0, cam_near_far=None, aabb=None,
               generator=None):
        if generator is not None:
            raise ValueError("the sharded eval render is deterministic")
        N = rays_o.shape[0]
        pad = (-N) % w
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
            rays_d = torch.cat([rays_d, rays_d.new_ones((pad, 3))])
        k = (N + pad) // w
        sl = slice(r * k, (r + 1) * k)
        out = render_staged(model, rays_o[sl], rays_d[sl], settings,
                            bg_color=bg_color, cam_near_far=cam_near_far,
                            aabb=aabb)
        return {key: _gather(v)[:N] for key, v in out.items()}

    return render
