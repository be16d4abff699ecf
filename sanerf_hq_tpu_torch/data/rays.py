"""Ray generation: pixel centres at +0.5, OpenGL-style camera
dirs = ((x-cx)/fx, -(y-cy)/fy, -1) left unnormalised so composited depth
is z-distance; rays_d = dirs @ R^T, rays_o = the pose translation."""
from __future__ import annotations

from typing import Optional

import torch


def dirs_from_pixels(x, y, intrinsics):
    """x, y: [...] pixel-centre coords; intrinsics: [4] (fx, fy, cx, cy)
    shared, or [..., 4] per ray."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    xs = (x - cx) / fx
    ys = -(y - cy) / fy  # y flipped
    zs = -torch.ones_like(xs)  # z flipped
    return torch.stack([xs, ys, zs], dim=-1)


def rays_from_pixels(poses, intrinsics, x, y):
    """poses: [N, 4, 4] or [4, 4] cam2world; x, y: [N] pixel centres.
    Returns rays_o, rays_d: [N, 3]."""
    dirs = dirs_from_pixels(x, y, intrinsics)
    if poses.dim() == 2:
        rays_d = dirs @ poses[:3, :3].T
        rays_o = poses[:3, 3].expand(rays_d.shape)
    else:
        rays_d = torch.einsum("nij,nj->ni", poses[:, :3, :3], dirs)
        rays_o = poses[:, :3, 3]
    return rays_o.contiguous(), rays_d.contiguous()


def full_frame_rays(pose, intrinsics, H: int, W: int):
    """All H*W rays of one view, row-major.  pose [4, 4] and intrinsics [4]
    float32 tensors on the target device.  Returns [H*W, 3] x2."""
    dev = pose.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    return rays_from_pixels(pose, intrinsics, xx.reshape(-1) + 0.5,
                            yy.reshape(-1) + 0.5)


def sample_random_pixels(H: int, W: int, n: int, device,
                         generator: Optional[torch.Generator] = None):
    """n uniform pixel indices (duplicates allowed, like torch.randint) and
    their pixel-centre coordinates.  Returns (inds [n] int64, x [n], y [n])."""
    inds = torch.randint(0, H * W, (n,), generator=generator, device=device)
    x = (inds % W).float() + 0.5
    y = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    return inds, x, y


def coarse_inds_from_fine(inds, H: int, W: int, map_size: int = 128):
    """Fine pixel indices -> their cells of a map_size x map_size error
    map."""
    rows = torch.div(inds, W, rounding_mode="floor")
    cols = inds % W
    cr = (rows * (map_size / H)).long()
    cc = (cols * (map_size / W)).long()
    return cr * map_size + cc
