"""SAM's mask decoder and HQ-SAM's (a high-quality token whose
hypernetwork reads a map fused from the early ViT features and the final
embedding).  Channels-last inputs, as in the JAX package."""
from __future__ import annotations

import torch
from torch import nn

from .common import LayerNorm2d, MLPHead, conv_nhwc
from .transformer import TwoWayTransformer


def _up_stack(c_in, c_mid, c_out, act_last=False):
    """ConvTranspose 2x2/2, LayerNorm2d, GELU, ConvTranspose 2x2/2 (and a
    last GELU): indices 0, 1, 3 as in the checkpoints."""
    layers = [nn.ConvTranspose2d(c_in, c_mid, 2, stride=2),
              LayerNorm2d(c_mid), nn.GELU(),
              nn.ConvTranspose2d(c_mid, c_out, 2, stride=2)]
    return nn.Sequential(*layers, *([nn.GELU()] if act_last else []))


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256):
        super().__init__()
        d = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(depth=2, embedding_dim=d,
                                             num_heads=8, mlp_dim=2048)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.output_upscaling = _up_stack(d, d // 4, d // 8, act_last=True)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLPHead(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLPHead(d, iou_head_hidden_dim,
                                           self.num_mask_tokens,
                                           iou_head_depth)

    def _run_transformer(self, extra_tokens, image_embeddings, image_pe,
                         sparse_prompt, dense_prompt):
        B = sparse_prompt.shape[0]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight,
                            *extra_tokens], dim=0)
        tokens = torch.cat([tokens[None].expand(B, -1, -1), sparse_prompt],
                           dim=1)
        hs, src = self.transformer(image_embeddings + dense_prompt, image_pe,
                                   tokens)
        h, w = image_embeddings.shape[1:3]
        up = conv_nhwc(self.output_upscaling, src.reshape(B, h, w, -1))
        return hs, up  # up: [B, 4h, 4w, C/8]

    def forward(self, image_embeddings, image_pe, sparse_prompt,
                dense_prompt, multimask_output: bool = True):
        """image_embeddings [B, h, w, C], image_pe [1, h, w, C], sparse
        [B, N, C], dense [B, h, w, C] -> (masks [B, T, 4h, 4w], iou [B,
        T]): the three multimask outputs, or the single one."""
        hs, up = self._run_transformer((), image_embeddings, image_pe,
                                       sparse_prompt, dense_prompt)
        mask_tokens = hs[:, 1:1 + self.num_mask_tokens]
        hyper = torch.stack([mlp(mask_tokens[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("btc,bhwc->bthw", hyper, up)
        iou = self.iou_prediction_head(hs[:, 0])
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], iou[:, sl]


class MaskDecoderHQ(MaskDecoder):
    """HQ-SAM's decoder: MaskDecoder's modules (the checkpoints' keys sit
    beside them, not under a prefix) plus the hf token and its fusion."""

    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, vit_dim: int = 1280):
        super().__init__(transformer_dim, num_multimask_outputs)
        d = transformer_dim
        self.hf_token = nn.Embedding(1, d)
        self.hf_mlp = MLPHead(d, d, d // 8, 3)
        self.compress_vit_feat = _up_stack(vit_dim, d, d // 8)
        self.embedding_encoder = _up_stack(d, d // 4, d // 8)
        self.embedding_maskfeature = nn.Sequential(
            nn.Conv2d(d // 8, d // 4, 3, padding=1), LayerNorm2d(d // 4),
            nn.GELU(), nn.Conv2d(d // 4, d // 8, 3, padding=1))

    def forward(self, image_embeddings, image_pe, sparse_prompt,
                dense_prompt, multimask_output: bool = True,
                interm_embeddings=None):
        """interm_embeddings: the first global block's ViT output [B, h, w,
        vit_dim].  Returns the SAM masks (multimask: the three, else the
        single one) and the HQ mask after them, with the base IoU."""
        if interm_embeddings is None:
            raise TypeError(
                "MaskDecoderHQ needs interm_embeddings, the ViT's global-"
                "block features: an injected feature map (set_features) has "
                "none, so sam_hq cannot decode from it (as in the "
                "reference); use set_image, or --sam_type sam")
        hq_feature = (conv_nhwc(self.embedding_encoder, image_embeddings)
                      + conv_nhwc(self.compress_vit_feat, interm_embeddings))
        hs, up = self._run_transformer((self.hf_token.weight,),
                                       image_embeddings, image_pe,
                                       sparse_prompt, dense_prompt)
        n = self.num_mask_tokens + 1
        mask_tokens = hs[:, 1:1 + n]
        up_hq = conv_nhwc(self.embedding_maskfeature, up) + hq_feature
        hyper = torch.stack([mlp(mask_tokens[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        hyper_hq = self.hf_mlp(mask_tokens[:, n - 1])[:, None]
        masks_sam = torch.einsum("btc,bhwc->bthw", hyper, up)
        masks_hq = torch.einsum("btc,bhwc->bthw", hyper_hq, up_hq)
        iou = self.iou_prediction_head(hs[:, 0])
        if multimask_output:
            masks_base, iou = masks_sam[:, 1:], iou[:, 1:n - 1]
        else:
            masks_base, iou = masks_sam[:, :1], iou[:, :1]
        return torch.cat([masks_base, masks_hq], dim=1), iou
