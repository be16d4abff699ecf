"""Mask and point overlays for the stage-3 results and the decode's
{stem}_rgb.png, and the incoherent-region mask of a mask's detail."""
from __future__ import annotations

import numpy as np

from ..data.provider import resize_linear, resize_nearest


def overlay_mask(image: np.ndarray, mask: np.ndarray,
                 color=(30 / 255, 144 / 255, 1.0), alpha: float = 0.6):
    """image [H, W, 3] float in [0, 1]; mask [H, W] bool-like.  The masked
    pixels blend toward `color` by `alpha`."""
    m = np.asarray(mask).astype(bool)
    out = image.copy()
    out[m] = (1 - alpha) * image[m] + alpha * np.asarray(color)
    return out


def overlay_mask_only(mask: np.ndarray):
    """mask [H, W] -> the mask as a float32 grey image [H, W, 3]."""
    m = np.asarray(mask).astype(np.float32)
    return np.repeat(m[..., None], 3, axis=-1)


def overlay_mask_heatmap(image: np.ndarray, prob: np.ndarray,
                         alpha: float = 0.6):
    """prob [H, W] in [0, 1] -> a red (1) to blue (0) heatmap blended over
    image by alpha."""
    p = np.clip(np.asarray(prob, np.float32), 0, 1)
    heat = np.stack([p, np.zeros_like(p), 1 - p], axis=-1)
    return (1 - alpha) * image + alpha * heat


def overlay_mask_composition(image: np.ndarray, mask: np.ndarray,
                             bg_color=1.0):
    """The image where the mask is set, bg_color elsewhere."""
    m = np.asarray(mask).astype(bool)[..., None]
    return np.where(m, image, bg_color)


def overlay_point(image: np.ndarray, coords: np.ndarray, radius: int = 4,
                  inputs_point_labels=None):
    """coords [N, 2] (x, y): a (2 radius + 1)-pixel square at each, green
    for a positive point, red for a negative one."""
    out = image.copy()
    H, W = image.shape[:2]
    for i, (x, y) in enumerate(np.asarray(coords)):
        pos = inputs_point_labels is None or inputs_point_labels[i] == 1
        color = (0.0, 1.0, 0.0) if pos else (1.0, 0.0, 0.0)
        y0, y1 = max(0, y - radius), min(H, y + radius + 1)
        x0, x1 = max(0, x - radius), min(W, x + radius + 1)
        out[y0:y1, x0:x1] = color
    return out


def get_incoherent_mask(input_masks, sfact: int = 2):
    """1 where a mask differs by more than 0.01 from itself shrunk by sfact
    (bilinear) and grown back (nearest): its boundary and detail.
    input_masks [H, W] or [N, H, W]; float32 out, same shape.  The resizes
    are OpenCV's INTER_LINEAR and INTER_NEAREST (data/provider.py)."""
    m = np.asarray(input_masks, np.float32)
    squeeze = m.ndim == 2
    if squeeze:
        m = m[None]
    h, w = m.shape[-2:]
    out = []
    for mm in m:
        small = resize_linear(mm, h // sfact, w // sfact)
        back = resize_nearest(small, h, w)
        out.append((np.abs(back - mm) > 0.01).astype(np.float32))
    res = np.stack(out)
    return res[0] if squeeze else res
