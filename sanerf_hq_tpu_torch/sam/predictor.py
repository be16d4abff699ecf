"""SamPredictor with the feature-injection seam SANeRF-HQ decodes through:
`set_features` takes a rendered or cached feature map instead of running
the encoder (its long side resized to the grid, zero-padded bottom and
right), then `predict` decodes point prompts.  Tensors live on the model's
device; `predict` returns numpy, as the JAX package's does."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import span
from ..utils.resize import resize_bilinear, resize_uint8_linear

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class SamPredictor:
    def __init__(self, sam, img_size: int = 1024):
        """sam: a built Sam module (build.py)."""
        self.sam = sam
        self.img_size = img_size
        self.device = next(sam.parameters()).device
        self.reset_image()

    def reset_image(self):
        self.features = None
        self.interm_features = None
        self.original_size = None
        self.input_size = None
        self.is_image_set = False

    # -- image path -------------------------------------------------------
    @torch.no_grad()
    def encode(self, x):
        """x [B, img, img, 3] normalised -> (features [B, g, g, 256], the
        global blocks' outputs)."""
        return self.sam.image_encoder(x, return_interm=True)

    def preprocess(self, image) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """uint8 RGB [H, W, 3] (numpy or tensor) -> the normalised, padded
        encoder input [1, img, img, 3] and the resized (h, w): the long side
        resized to img_size with OpenCV's uint8 bilinear, as set_image's
        cv2.resize in JAX."""
        img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                              else image, device=self.device)
        H, W = img.shape[:2]
        ratio = self.img_size / max(H, W)
        newh, neww = int(H * ratio + 0.5), int(W * ratio + 0.5)
        img = resize_uint8_linear(img, newh, neww).float()
        mean = torch.tensor(PIXEL_MEAN, device=self.device)
        std = torch.tensor(PIXEL_STD, device=self.device)
        x = torch.zeros(1, self.img_size, self.img_size, 3,
                        device=self.device)
        x[0, :newh, :neww] = (img - mean) / std
        return x, (newh, neww)

    def set_image(self, image):
        """image: uint8 RGB [H, W, 3].  Returns the features [1, g, g,
        256].  Spans: `sanerf.sam.preprocess`, then the encoder's."""
        with span("sanerf.sam.preprocess"):
            x, input_size = self.preprocess(image)
        feats, interm = self.encode(x)
        self.features = feats
        self.interm_features = interm
        self.original_size = tuple(image.shape[:2])
        self.input_size = input_size
        self.is_image_set = True
        return feats

    def set_features(self, features, original_size: Tuple[int, int],
                     interm_features=None):
        """Inject a rendered or cached feature map [h, w, C] or [1, h, w, C]
        (numpy or tensor): resized (jax.image.resize's bilinear) so its long
        side is the grid (img_size / 16), then zero-padded bottom and
        right."""
        f = torch.as_tensor(np.asarray(features) if not torch.is_tensor(
            features) else features, dtype=torch.float32, device=self.device)
        if f.ndim == 3:
            f = f[None]
        h, w = f.shape[1:3]
        grid = self.img_size // 16
        ratio = grid / max(h, w)
        nh, nw = int(h * ratio), int(w * ratio)
        f = resize_bilinear(f, (1, nh, nw, f.shape[-1]))
        self.features = torch.nn.functional.pad(
            f, (0, 0, 0, grid - nw, 0, grid - nh))
        self.interm_features = interm_features
        H, W = original_size
        ratio_img = self.img_size / max(H, W)
        self.original_size = (H, W)
        self.input_size = (int(H * ratio_img), int(W * ratio_img))
        self.is_image_set = True

    # -- prompts and decode -------------------------------------------------
    def transform_coords(self, coords: np.ndarray) -> np.ndarray:
        """Original-image pixel coordinates -> model-input coordinates,
        truncated to int32 (as the JAX package does; stock SAM keeps the
        fraction)."""
        H, W = self.original_size
        ratio = self.img_size / max(H, W)
        return (coords.astype(np.float32) * ratio).astype(np.int32)

    @torch.no_grad()
    def decode(self, features, coords, labels, mask_input=None,
               multimask_output: bool = True, interm=None):
        """features [1, g, g, 256], coords [1, N, 2], labels [1, N] ->
        (low-res logits [1, T, 4g, 4g], iou [1, T])."""
        pe = self.sam.prompt_encoder
        sparse, dense = pe(points=coords, labels=labels, masks=mask_input)
        image_pe = pe.get_dense_pe()[None]
        if self.sam.is_hq:
            return self.sam.mask_decoder(features, image_pe, sparse, dense,
                                         multimask_output, interm)
        return self.sam.mask_decoder(features, image_pe, sparse, dense,
                                     multimask_output)

    def predict(self, point_coords=None, point_labels=None, mask_input=None,
                multimask_output: bool = True, return_logits: bool = False):
        """point_coords [N, 2] in model-input space.  Returns numpy (masks
        [T, H, W] bool, or logits with return_logits; iou [T]; low-res
        logits [T, 4g, 4g]).  With sam_hq the HQ head reads the first global
        block's features, which only set_image gives."""
        assert self.is_image_set
        dev = self.device
        coords = torch.as_tensor(np.asarray(point_coords, np.float32),
                                 device=dev)[None]
        labels = torch.as_tensor(np.asarray(point_labels, np.int32),
                                 device=dev)[None]
        mi = None
        if mask_input is not None:
            mi = torch.as_tensor(np.asarray(mask_input, np.float32),
                                 device=dev)
            if mi.ndim == 3:
                mi = mi[..., None] if mi.shape[0] == 1 else mi[..., None][None]
        interm = (self.interm_features[0]
                  if self.interm_features is not None else None)
        low_res, iou = self.decode(self.features, coords, labels, mi,
                                   multimask_output, interm)
        low_res, iou = low_res[0], iou[0]
        masks = self._upscale(low_res)
        if not return_logits:
            masks = masks > 0.0
        return (masks.cpu().numpy(), iou.cpu().numpy(),
                low_res.cpu().numpy())

    def _upscale(self, low_res):
        """[T, 4g, 4g] logits -> original_size: resized to img_size, cropped
        to the input size, resized to the original size (jax.image.resize's
        bilinear both times, antialiased where it shrinks)."""
        T = low_res.shape[0]
        x = resize_bilinear(low_res, (T, self.img_size, self.img_size))
        ih, iw = self.input_size
        H, W = self.original_size
        return resize_bilinear(x[:, :ih, :iw], (T, H, W))
