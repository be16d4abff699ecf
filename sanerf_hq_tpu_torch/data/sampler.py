"""Ray batches, drawn on the device from the preloaded views with an
explicit torch.Generator (on the tensors' device): the stage-1 RGB batch
and the stage-3 mask batch (error-map-guided global rays plus local
patches); and the cameras: stage 2's distill camera of random field of
view and the fixed fovy-60 camera of stages 2 and 3."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .rays import coarse_inds_from_fine, rays_from_pixels, sample_random_pixels


def sample_rgb_batch(generator: Optional[torch.Generator], images, poses,
                     intrinsics, n_rays: int, random_image_batch: bool = True,
                     cam_near_far=None):
    """images [V, H, W, C], poses [V, 4, 4], intrinsics [4] shared or
    [V, 4] per view, all on one device.  Returns {rays_o, rays_d [n, 3],
    gt_rgb [n, C], img_inds, pix_inds [n]}, plus cam_near_far [n, 2] when
    a per-view [V, 2] is given.

    random_image_batch draws every ray's view at random; otherwise one
    random view serves the whole batch.  Each ray carries its own view's
    intrinsics and near/far, as the reference collate does."""
    V, H, W = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    if random_image_batch:
        img_inds = torch.randint(0, V, (n_rays,), generator=generator,
                                 device=dev)
    else:
        img_inds = torch.randint(0, V, (1,), generator=generator,
                                 device=dev).expand(n_rays)
    pix_inds, x, y = sample_random_pixels(H, W, n_rays, dev, generator)
    rows = torch.div(pix_inds, W, rounding_mode="floor")
    cols = pix_inds % W
    intr = intrinsics[img_inds] if intrinsics.dim() == 2 else intrinsics
    rays_o, rays_d = rays_from_pixels(poses[img_inds], intr, x, y)
    batch = {"rays_o": rays_o, "rays_d": rays_d,
             "gt_rgb": images[img_inds, rows, cols],
             "img_inds": img_inds, "pix_inds": pix_inds}
    if cam_near_far is not None:
        batch["cam_near_far"] = cam_near_far[img_inds]
    return batch


def sample_mask_batch(generator: Optional[torch.Generator], masks, poses,
                      intrinsics, error_map, n_rays: int, num_local: int,
                      patch_size: int, H: int, W: int,
                      error_map_size: int = 128, use_error_map: bool = True):
    """Stage-3 batch (JAX sampler.py:57-137).  masks [V, H, W] int labels,
    poses [V, 4, 4], intrinsics [4] shared, error_map [V, S*S], all on one
    device.

    n_rays global rays, each from a uniformly drawn view; with
    use_error_map each takes a cell of its view's error map with
    probability proportional to the map (the JAX sampler's Gumbel argmax,
    drawn here with torch.multinomial: one categorical draw a ray over the
    view-normalised maps of all views) and a uniform pixel inside the
    cell, else a uniform pixel.  Then num_local
    patch_size^2 patches, each from a uniformly drawn view, centred on a
    cell drawn from that view's map the same way (or placed uniformly).

    Returns {rays_o, rays_d [n_rays + num_local*patch_size^2, 3] (global
    rays first), gt_masks [same], img_inds, inds_coarse [n_rays],
    local_error [num_local*patch_size^2] (the map at each patch ray)}."""
    V, S = poses.shape[0], error_map_size
    dev = poses.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    sx, sy = H / S, W / S
    if use_error_map:
        # one draw a ray over every view's cells, each view's row scaled
        # to sum 1: the view is uniform and the cell follows its view's
        # map, as the Gumbel argmax draws them
        probs = error_map.clamp_min(1e-12)
        probs = probs / probs.sum(-1, keepdim=True)
        idx = torch.multinomial(probs.reshape(-1), n_rays, replacement=True,
                                generator=generator)
        img_inds = torch.div(idx, S * S, rounding_mode="floor")
        inds_coarse = idx % (S * S)
        rows = ((torch.div(inds_coarse, S, rounding_mode="floor") * sx
                 + rand(n_rays) * sx).long()).clamp(0, H - 1)
        cols = (((inds_coarse % S) * sy + rand(n_rays) * sy).long()).clamp(
            0, W - 1)
    else:
        img_inds = torch.randint(0, V, (n_rays,), generator=generator,
                                 device=dev)
        pix, _, _ = sample_random_pixels(H, W, n_rays, dev, generator)
        rows, cols = torch.div(pix, W, rounding_mode="floor"), pix % W
        inds_coarse = coarse_inds_from_fine(pix, H, W, S)
    rays_o, rays_d = rays_from_pixels(poses[img_inds], intrinsics,
                                      cols.float() + 0.5, rows.float() + 0.5)
    gt_g = masks[img_inds, rows, cols]

    S2 = patch_size * patch_size
    local_views = torch.randint(0, V, (num_local,), generator=generator,
                                device=dev)
    if use_error_map:
        centers = torch.multinomial(error_map[local_views].clamp_min(1e-12),
                                    1, generator=generator)[:, 0]
        # truncation toward zero, then the clamp, as the JAX int cast
        x0 = (torch.div(centers, S, rounding_mode="floor") * sx
              - patch_size // 2).long().clamp(0, H - patch_size - 1)
        y0 = ((centers % S) * sy - patch_size // 2).long().clamp(
            0, W - patch_size - 1)
    else:
        x0 = torch.randint(0, H - patch_size, (num_local,),
                           generator=generator, device=dev)
        y0 = torch.randint(0, W - patch_size, (num_local,),
                           generator=generator, device=dev)
    off = torch.arange(patch_size, device=dev)
    lrows = (x0[:, None, None] + off[None, :, None]).expand(
        -1, -1, patch_size).reshape(-1)
    lcols = (y0[:, None, None] + off[None, None, :]).expand(
        -1, patch_size, -1).reshape(-1)
    lviews = local_views.repeat_interleave(S2)
    lro, lrd = rays_from_pixels(poses[lviews], intrinsics,
                                lcols.float() + 0.5, lrows.float() + 0.5)
    scale = S / H
    l_coarse = ((lrows.float() * scale).long() * S
                + (lcols.float() * scale).long())
    return {
        "rays_o": torch.cat([rays_o, lro]),
        "rays_d": torch.cat([rays_d, lrd]),
        "gt_masks": torch.cat([gt_g, masks[lviews, lrows, lcols]]),
        "img_inds": img_inds,
        "inds_coarse": inds_coarse,
        "local_error": error_map[lviews, l_coarse],
    }


def fixed_fovy_intrinsics(resolution: int, fovy_deg: float = 60.0):
    """[fx, fy, cx, cy] of a square resolution x resolution camera with
    the given vertical field of view (numpy float32)."""
    focal = resolution / (2.0 * np.tan(0.5 * np.deg2rad(fovy_deg)))
    return np.array([focal, focal, resolution / 2, resolution / 2],
                    np.float32)


def fovy_intrinsics(fovy, resolution: int) -> torch.Tensor:
    """[fx, fy, cx, cy] float32 of a square resolution x resolution camera
    of vertical field of view fovy (degrees; a float or a 0-d tensor),
    computed in float32 as the JAX sampler computes it."""
    fovy = torch.as_tensor(fovy, dtype=torch.float32)
    focal = resolution / (2.0 * torch.tan(0.5 * fovy * (np.pi / 180.0)))
    half = torch.full((), resolution / 2.0)
    return torch.stack([focal, focal, half, half])


def sam_aug_intrinsics(generator: Optional[torch.Generator],
                       online_resolution: int) -> torch.Tensor:
    """Stage 2's distill camera: fovy drawn uniformly in [50, 70) degrees
    (JAX data/sampler.py:140-146) from a CPU generator, at
    online_resolution.  Returns [fx, fy, cx, cy] on the CPU."""
    fovy = 50.0 + 20.0 * torch.rand((), generator=generator)
    return fovy_intrinsics(fovy, online_resolution)
