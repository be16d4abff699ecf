"""Mask overlay for the stage-3 result images."""
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
