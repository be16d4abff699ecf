"""Ray-domain ops: AABB intersection, spacing functions, inverse-CDF sampling."""
from __future__ import annotations

from typing import Optional

import torch

from .sample_pdf import sample_pdf_lookup


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.05):
    """Slab-test ray/AABB intersection.  aabb: [6] = (xmin, ymin, zmin,
    xmax, ymax, zmax).  Returns near, far of shape [N, 1]; rays that miss
    get near = far = 1e9; near is clamped to min_near."""
    tmin = (aabb[:3] - rays_o) / (rays_d + 1e-15)
    tmax = (aabb[3:] - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(tmin, tmax).amax(dim=-1, keepdim=True)
    far = torch.maximum(tmin, tmax).amin(dim=-1, keepdim=True)
    miss = far < near
    near = torch.where(miss, torch.full_like(near, 1e9), near)
    far = torch.where(miss, torch.full_like(far, 1e9), far)
    return near.clamp_min(min_near), far


def spacing_fn(x):
    """Mixed linear/lindisp warp: t < 1 -> t/2, else 1 - 1/(2t)."""
    return torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * x.clamp_min(1e-8)))


def spacing_fn_inv(s):
    """Inverse warp: s < 0.5 -> 2s, else 1/(2-2s)."""
    return torch.where(s < 0.5, 2.0 * s, 1.0 / (2.0 - 2.0 * s).clamp_min(1e-8))


def stratified_queries(n: int, q: int, device,
                       generator: Optional[torch.Generator] = None):
    """[n, q] midpoints of q uniform strata, jittered by +-0.5/q when a
    generator is given (perturbed sampling)."""
    u = torch.linspace(0.5 / q, 1.0 - 0.5 / q, q, device=device)
    u = u.expand(n, q)
    if generator is not None:
        u = u + (torch.rand((n, q), generator=generator, device=device)
                 - 0.5) / q
    return u


def sample_pdf(bins, weights, T: int,
               generator: Optional[torch.Generator] = None):
    """Inverse-CDF resampling of `T` new bin edges from a weight histogram.

    bins: [N, T0+1] edges, weights: [N, T0].  Weights get +0.01 flooring;
    the CDF is the cumsum clamped to 1 with a leading zero; queries are the
    midpoints of T uniform strata, jittered when `generator` is given.  The
    lookup is K10 (`ops/sample_pdf.py`) on the card and its plain version
    on the CPU; the result carries no gradient (the caller detaches it).
    """
    weights = weights.detach() + 0.01
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1).clamp_max(1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = stratified_queries(weights.shape[0], T, weights.device, generator)
    return sample_pdf_lookup(cdf, bins.detach().contiguous(), u.contiguous())
