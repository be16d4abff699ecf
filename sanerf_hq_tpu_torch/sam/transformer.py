"""The two-way transformer of SAM's mask decoder."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .common import MLPBlock


class AttentionDS(nn.Module):
    """Attention with the channels downsampled inside by downsample_rate."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def _split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads
                         ).transpose(1, 2)

    def forward(self, q, k, v):
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        attn = (q @ k.transpose(-2, -1)) / (q.shape[-1] ** 0.5)
        out = attn.softmax(dim=-1) @ v
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = AttentionDS(embedding_dim, num_heads)
        self.norm1 = nn.LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = AttentionDS(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = nn.LayerNorm(embedding_dim)
        # the two-way transformer's MLP is ReLU, unlike the ViT blocks'
        self.mlp = MLPBlock(embedding_dim, mlp_dim, act=F.relu)
        self.norm3 = nn.LayerNorm(embedding_dim)
        self.norm4 = nn.LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = AttentionDS(
            embedding_dim, num_heads, attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            # the first layer replaces the queries: no residual
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries
                             + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = AttentionDS(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding [B, h, w, C], image_pe [1 or B, h, w, C],
        point_embedding [B, N, C] -> (queries [B, N, C], keys [B, h*w,
        C])."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(-1, h * w, c).expand(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
