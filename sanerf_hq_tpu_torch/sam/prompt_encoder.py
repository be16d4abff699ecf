"""SAM's prompt encoder: points, boxes and masks -> sparse and dense
embeddings (channels-last, as in the JAX package)."""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .common import LayerNorm2d, conv_nhwc


class PositionEmbeddingRandom(nn.Module):
    """Random Fourier position encoding; its gaussian matrix is a buffer of
    the checkpoints."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords_norm):
        """coords_norm in [0, 1], [..., 2] -> [..., 2 * num_pos_feats]."""
        coords = 2.0 * coords_norm - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid_pe(self, size: Tuple[int, int]):
        """Dense encoding of an [h, w] grid at the cell centres (i + 0.5) /
        n, x along the columns -> [h, w, C]."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self(grid)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2 / 3: box corners
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self):
        return self.pe_layer.grid_pe(self.image_embedding_size)  # [h, w, C]

    def _input_wh(self, like):
        return torch.tensor([self.input_image_size[1],
                             self.input_image_size[0]], dtype=torch.float32,
                            device=like.device)

    def _embed_points(self, points, labels, pad: bool):
        """points [B, N, 2] in input-image pixels; labels [B, N] in {-1
        (pad), 0 (negative), 1 (positive)}.  The +0.5 moves each point to
        its pixel's centre."""
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros(
                points.shape[0], 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(
                labels.shape[0], 1)], dim=1)
        pe = self.pe_layer(points / self._input_wh(points))
        lbl = labels[..., None]
        out = torch.where(lbl == -1, self.not_a_point_embed.weight[0], 0.0) \
            + torch.where(lbl == -1, 0.0, pe)
        out = out + torch.where(lbl == 0, self.point_embeddings[0].weight[0],
                                0.0)
        return out + torch.where(lbl == 1, self.point_embeddings[1].weight[0],
                                 0.0)

    def _embed_boxes(self, boxes):
        """boxes [B, 4] -> [B, 2, C]."""
        boxes = boxes + 0.5
        pe = self.pe_layer(boxes.reshape(-1, 2, 2) / self._input_wh(boxes))
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return pe + corner

    def _embed_masks(self, masks):
        """masks [B, 4h, 4w, 1] -> [B, h, w, C]."""
        return conv_nhwc(self.mask_downscaling, masks)

    def forward(self, points=None, labels=None, boxes=None, masks=None):
        """Returns (sparse [B, N, C], dense [B, h, w, C])."""
        bs = 1
        dev = self.no_mask_embed.weight.device
        sparse = []
        if points is not None:
            bs = points.shape[0]
            sparse.append(self._embed_points(points, labels,
                                             pad=boxes is None))
        if boxes is not None:
            bs = boxes.shape[0]
            sparse.append(self._embed_boxes(boxes))
        sparse = (torch.cat(sparse, dim=1) if sparse
                  else torch.zeros(bs, 0, self.embed_dim, device=dev))
        if masks is not None:
            dense = self._embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight[0].reshape(1, 1, 1, -1).expand(
                bs, h, w, self.embed_dim)
        return sparse, dense
