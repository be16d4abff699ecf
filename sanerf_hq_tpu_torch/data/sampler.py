"""Stage-1 ray batches, drawn on the device from the preloaded views with
an explicit torch.Generator (on the tensors' device)."""
from __future__ import annotations

from typing import Optional

import torch

from .rays import rays_from_pixels, sample_random_pixels


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
