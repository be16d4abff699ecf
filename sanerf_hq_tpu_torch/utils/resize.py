"""The two resizes the SAM predictor needs, written out so that neither
OpenCV nor JAX is needed (the card's machine has neither):

- `resize_uint8_linear`: OpenCV's `cv2.resize(img, (w, h),
  interpolation=cv2.INTER_LINEAR)` on uint8 images, bit for bit.  OpenCV
  takes 11-bit fixed-point weights (`INTER_RESIZE_COEF_BITS`), sums the
  horizontal taps in int32, and rounds the vertical sum the way its SIMD
  row kernel does: each row term shifted right by 4, multiplied by its
  weight and shifted right by 16, the two added, then (s + 2) >> 2.  An
  exact 2x shrink is its box filter, which that formula also gives.
- `resize_bilinear`: `jax.image.resize(x, shape, "bilinear")`, which
  widens the triangle kernel by the shrink factor (antialiasing) and
  renormalises the taps that fall inside the input, one weight matrix a
  resized axis.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _cv_taps(dst: int, src: int, clamp: bool):
    """Per output index: the first source index and the two fixed-point
    weights.  The horizontal taps are clamped into the row (a left index
    < 0 or >= src - 1 takes one tap of weight 1); the vertical ones are
    not: their rows are clamped instead, as OpenCV does."""
    scale = 1.0 / (dst / src)  # as cv::resize computes it
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        lo = s < 0
        f[lo], s[lo] = 0.0, 0
        hi = s >= src - 1
        f[hi], s[hi] = 0.0, src - 1
    w0 = np.rint((np.float32(1.0) - f) * _COEF_SCALE).astype(np.int64)
    w1 = np.rint(f * _COEF_SCALE).astype(np.int64)
    return s, w0, w1


def resize_uint8_linear(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """img: uint8 [h, w, C] (any device) -> uint8 [H, W, C], equal to
    cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)."""
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.clone()
    dev = img.device
    x = img.to(torch.int32)
    sx, a0, a1 = (torch.as_tensor(t, device=dev) for t in _cv_taps(W, w, True))
    sx1 = (sx + 1).clamp_max(w - 1)
    a0 = a0.to(torch.int32)[:, None]
    a1 = a1.to(torch.int32)[:, None]
    rows = x[:, sx] * a0 + x[:, sx1] * a1  # [h, W, C], int32
    sy, b0, b1 = (torch.as_tensor(t, device=dev)
                  for t in _cv_taps(H, h, False))
    r0 = rows[sy.clamp(0, h - 1)] >> 4
    r1 = rows[(sy + 1).clamp(0, h - 1)] >> 4
    b0 = b0.to(torch.int32)[:, None, None]
    b1 = b1.to(torch.int32)[:, None, None]
    s = ((r0 * b0) >> 16) + ((r1 * b1) >> 16)
    return ((s + 2) >> 2).clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _bilinear_weights(n_in: int, n_out: int, device: str) -> torch.Tensor:
    return bilinear_weights(n_in, n_out, device)


def bilinear_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """The [n_out, n_in] weight matrix of jax.image.resize's bilinear
    kernel along one axis (float32, as JAX computes it)."""
    inv = np.float32(1.0 / (n_out / n_in))
    kscale = max(float(inv), 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / np.float32(kscale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)  # [n_in, n_out]
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0).astype(np.float32)
    return torch.as_tensor(w.T.copy(), device=device)


def resize_bilinear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.image.resize(x, shape, method="bilinear") for float x: each axis
    whose size changes is contracted with its weight matrix."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match x's rank "
                         f"{x.ndim}")
    for d, n in enumerate(shape):
        if x.shape[d] == n:
            continue
        # built on the host once per (sizes, device); read-only after
        w = _bilinear_weights(x.shape[d], n, str(x.device)).to(x.dtype)
        x = torch.movedim(torch.tensordot(w, torch.movedim(x, d, 0), dims=1),
                          0, d)
    return x
