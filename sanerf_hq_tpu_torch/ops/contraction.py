"""MERF / mip-NeRF-360 infinity-norm scene contraction and its inverse.

Points with inf-norm magnitude below 1 pass through; outside, every
coordinate is divided by the magnitude except the arg-max coordinate, which
maps to sign(x) * (2 - 1/mag), keeping the contracted domain inside
[-2, 2]^3.
"""
import torch


def contract(x):
    """x: [..., C] -> contracted z: [..., C]."""
    ax = x.abs()
    mag = ax.amax(dim=-1, keepdim=True)
    is_max = ax == mag  # ties apply the max-scale to every tied coordinate
    inv = 1.0 / mag.clamp_min(1e-38)
    scale = torch.where(is_max, (2.0 - inv) * inv, inv)
    return torch.where(mag < 1.0, x, x * scale)


def uncontract(z):
    """The inverse of contract on its image (inf-norm < 2): z: [..., C]."""
    az = z.abs()
    mag = az.amax(dim=-1, keepdim=True)
    is_max = az == mag
    scale_other = 1.0 / (2.0 - mag).clamp_min(1e-8)
    scale_max = 1.0 / (2.0 * mag - mag * mag).clamp_min(1e-8)
    scale = torch.where(is_max, scale_max, scale_other)
    return torch.where(mag < 1.0, z, z * scale)
