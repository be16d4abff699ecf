"""SAM's ViT image encoder: a 16x16 patch embedding, absolute and
decomposed relative position embeddings, windowed attention except at the
global blocks, and a two-convolution neck to 256 channels.  Channels-last
in and out: [B, img, img, 3] -> [B, img/16, img/16, 256] and, with
return_interm, the outputs of the global blocks (HQ-SAM's interm
embeddings).  Attention is plain matmul, softmax, matmul in fp32, as the
JAX package computes it (sam/image_encoder.py there).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..utils.resize import resize_bilinear
from .common import LayerNorm2d, MLPBlock


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """The relative position embeddings [q_size, k_size, dim] for query
    and key sizes; rel_pos [2 * max - 1, dim] is resized along its first
    axis (jax.image.resize, linear) when its length differs."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_bilinear(rel_pos, (max_rel_dist, rel_pos.shape[1]))
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(
        k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(
        q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """attn [B*nh, qh*qw, kh*kw] plus the decomposed rel-pos bias of the
    unscaled queries q [B*nh, qh*qw, dim]."""
    qh, qw = q_size
    kh, kw = k_size
    Rh = get_rel_pos(qh, kh, rel_pos_h)
    Rw = get_rel_pos(qw, kw, rel_pos_w)
    B = q.shape[0]
    r_q = q.reshape(B, qh, qw, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.reshape(B, qh, qw, kh, kw)
    attn = attn + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.reshape(B, qh * qw, kh * kw)


def window_partition(x, window_size: int):
    """x [B, H, W, C] -> windows [B*nW, ws, ws, C], zero-padded bottom and
    right to a multiple of the window, and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    x = nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size,
                  window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                                  window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size,
                        window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 input_size: Tuple[int, int] = (14, 14)):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(
            torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(
            torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):  # [B, H, W, C]
        B, H, W, C = x.shape
        nh = self.num_heads
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, nh, -1)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, H * W, -1)
        q, k, v = qkv.unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h,
                                      self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).reshape(B, nh, H, W, -1)
        x = x.permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj(x)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 window_size: int = 0,
                 input_size: Tuple[int, int] = (64, 64)):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads,
                              input_size=(input_size if window_size == 0
                                          else (window_size, window_size)))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):  # [B, H, W, C]
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):  # [B, H, W, 3] -> [B, H/p, W/p, D]
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 out_chans: int = 256, window_size: int = 14,
                 global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)):
        super().__init__()
        self.global_attn_indexes = tuple(global_attn_indexes)
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  window_size=(0 if i in self.global_attn_indexes
                               else window_size),
                  input_size=(grid, grid))
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))

    def forward(self, x, return_interm: bool = False):
        """x: [B, img, img, 3] normalised.  Returns [B, img/16, img/16,
        out_chans] (and the global blocks' outputs if return_interm)."""
        x = self.patch_embed(x) + self.pos_embed
        interm = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.global_attn_indexes:
                interm.append(x)
        y = self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return (y, interm) if return_interm else y


def vit_h_config():
    return dict(embed_dim=1280, depth=32, num_heads=16,
                global_attn_indexes=(7, 15, 23, 31))


def vit_l_config():
    return dict(embed_dim=1024, depth=24, num_heads=16,
                global_attn_indexes=(5, 11, 17, 23))


def vit_b_config():
    return dict(embed_dim=768, depth=12, num_heads=12,
                global_attn_indexes=(2, 5, 8, 11))
