"""SAM model registry: `build_sam` gives the image encoder, the prompt
encoder and the mask decoder in one module whose state_dict is a released
checkpoint's (sam_vit_{b,l,h}_*.pth, sam_hq_vit_{b,l,h}.pth)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from .common import LayerNorm2d
from .image_encoder import (Attention, ImageEncoderViT, vit_b_config,
                            vit_h_config, vit_l_config)
from .mask_decoder import MaskDecoder, MaskDecoderHQ
from .prompt_encoder import PositionEmbeddingRandom, PromptEncoder

# model type -> the encoder's arguments; tests add small entries here
_CONFIGS = {"vit_h": vit_h_config, "vit_l": vit_l_config,
            "vit_b": vit_b_config}


class Sam(nn.Module):
    def __init__(self, image_encoder, prompt_encoder, mask_decoder,
                 is_hq: bool = False):
        super().__init__()
        self.image_encoder = image_encoder
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder
        self.is_hq = is_hq


def random_init_(model: nn.Module, generator: torch.Generator):
    """Random weights from one generator, module by module in
    registration order: linear and convolution weights normal / sqrt(fan
    in) with zero biases, embeddings and the position encoding's gaussian
    matrix unit normal, norms ones and zeros, the position embeddings and
    rel-pos tables normal * 0.02."""
    def normal_(t, std=1.0):
        t.copy_(torch.randn(t.shape, generator=generator,
                            device=t.device) * std)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else w.shape[1]) * w[0, 0].numel()
                normal_(w, fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal_(m.weight)
            elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, PositionEmbeddingRandom):
                normal_(m.positional_encoding_gaussian_matrix)
            elif isinstance(m, Attention):
                normal_(m.rel_pos_h, 0.02)
                normal_(m.rel_pos_w, 0.02)
            elif isinstance(m, ImageEncoderViT):
                normal_(m.pos_embed, 0.02)


def build_sam(model_type: str = "vit_h", checkpoint: Optional[str] = None,
              hq: bool = False, img_size: int = 1024, seed: int = 0,
              device=None) -> Sam:
    """The model on `device` (the card unless "cpu" is asked for): from a
    checkpoint if one is given, else random weights from a generator
    seeded with `seed` on that device.  "meta" builds the modules without
    memory."""
    dev = torch.device("meta") if str(device) == "meta" else \
        resolve_device(device)
    cfg = _CONFIGS[model_type]()
    grid = img_size // 16
    with torch.device(dev):
        model = Sam(
            ImageEncoderViT(img_size=img_size, **cfg),
            PromptEncoder(image_embedding_size=(grid, grid),
                          input_image_size=(img_size, img_size)),
            MaskDecoderHQ(vit_dim=cfg["embed_dim"]) if hq else MaskDecoder(),
            is_hq=hq)
    if dev.type == "meta":
        return model
    if checkpoint is not None:
        from .weights import load_sam_checkpoint

        model.load_state_dict(load_sam_checkpoint(checkpoint), strict=True)
    else:
        gen = torch.Generator(dev)
        gen.manual_seed(seed)
        random_init_(model, gen)
    return model.eval().requires_grad_(False)


def sam_model_registry(model_type: str = "vit_h", checkpoint=None, **kw):
    return build_sam(model_type, checkpoint, **kw)
