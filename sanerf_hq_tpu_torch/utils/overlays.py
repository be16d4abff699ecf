"""Mask and point overlays for the stage-3 results and the decode's
{stem}_rgb.png."""
from __future__ import annotations

import numpy as np


def overlay_mask(image: np.ndarray, mask: np.ndarray,
                 color=(30 / 255, 144 / 255, 1.0), alpha: float = 0.6):
    """image [H, W, 3] float in [0, 1]; mask [H, W] bool-like.  The masked
    pixels blend toward `color` by `alpha`."""
    m = np.asarray(mask).astype(bool)
    out = image.copy()
    out[m] = (1 - alpha) * image[m] + alpha * np.asarray(color)
    return out


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
