"""Plain reference of SAM's image encoder and its preprocessing, in plain
PyTorch, from the published description: Kirillov et al., "Segment
Anything" (ICCV 2023, arXiv:2304.02643) and its code,
facebookresearch/segment-anything `modeling/image_encoder.py` (the ViT
with windowed and global attention and decomposed relative positions)
and `predictor.py` / `utils/transforms.py` (set_image's resize,
normalisation and padding).  HQ-SAM (arXiv:2306.01567) keeps this encoder
frozen and reads the global blocks' outputs as its interm embeddings.

  preprocess(image, img_size)  uint8 [H, W, 3] -> the encoder's input
                               [1, img, img, 3] and the resized (h, w);
  encode(params, x, cfg, mode) that input -> (features [B, g, g,
                               out_chans], the global blocks' outputs),
                               g = img_size / patch_size.

`params` are named as in the released checkpoints (`sam_vit_h_4b8939.pth`
without the `image_encoder.` prefix); `cfg` holds the widths
(`img_size`, `patch_size`, `embed_dim`, `depth`, `num_heads`,
`mlp_ratio`, `out_chans`, `window_size`, `global_attn_indexes`).

Every product (the linears, the patch and neck convolutions, QK^T, the
relative-position einsums, AV) takes its operands at `mode`'s precision
through `common.round_to` ('fp32', 'tf32', 'bf16'), with fp32 sums:
`encode` turns TF32 off in the backends, so 'fp32' is fp32 and 'tf32' is
what a TF32 tensor core takes.  Nothing here imports the program under
test or JAX.

Departures from the publication:
  - The resize.  segment-anything resizes the long side through PIL's
    bilinear (torchvision's `resize` on a PIL image); the JAX package and
    the port use OpenCV's uint8 `INTER_LINEAR` (11-bit fixed-point
    weights).  This reference interpolates in float at pixel centres
    (`F.interpolate`, bilinear, no corner alignment, no antialiasing: an
    upscale) and rounds to uint8, which neither matches bit for bit: the
    benchmark holds the program's preprocessed input to this one under a
    limit of its own (at most a level in 255) and then encodes the
    program's input, so that the encoder's comparison sees one input.
  - Channels-last out: the features come back [B, g, g, C] (the port's
    layout), where segment-anything returns [B, C, g, g].
  - Attention runs a head at a time, so that a global block's [4096,
    4096] logits fit one head at a time; the arithmetic is the same.
  - The relative-position tables must be 2 * size - 1 long, as they are
    at every published size; the publication's interpolation of other
    lengths is left out (a ValueError)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import round_to

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
EPS = 1e-6  # the blocks' LayerNorm and the neck's LayerNorm2d


def preprocess(image: torch.Tensor, img_size: int
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """uint8 [H, W, 3] -> the normalised input [1, img, img, 3], its long
    side resized to img_size (the short side int(s * scale + 0.5)) and
    zero-padded bottom and right after the normalisation; and the
    resized (h, w)."""
    H, W = image.shape[:2]
    scale = img_size / max(H, W)
    h, w = int(H * scale + 0.5), int(W * scale + 0.5)
    x = image.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    x = torch.floor(x + 0.5).clamp(0, 255)[0].permute(1, 2, 0)
    mean = torch.tensor(PIXEL_MEAN, device=x.device)
    std = torch.tensor(PIXEL_STD, device=x.device)
    out = torch.zeros(1, img_size, img_size, 3, device=x.device)
    out[0, :h, :w] = (x - mean) / std
    return out, (h, w)


def _linear(x, p: Dict[str, torch.Tensor], name: str, mode: str):
    y = round_to(x, mode) @ round_to(p[name + ".weight"], mode).t()
    b = p.get(name + ".bias")
    return y if b is None else y + b


def _conv(x, w, mode: str, **kw):
    return F.conv2d(round_to(x, mode), round_to(w, mode), **kw)


def _layer_norm(x, p, name: str):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return ((x - mu) / torch.sqrt(var + EPS) * p[name + ".weight"]
            + p[name + ".bias"])


def _rel_pos(size: int, table: torch.Tensor) -> torch.Tensor:
    """The table's rows for each (query, key) offset along one axis of a
    square attention: [size, size, head_dim]."""
    if table.shape[0] != 2 * size - 1:
        raise ValueError(f"relative-position table of {table.shape[0]} "
                         f"rows for size {size}")
    q = torch.arange(size, device=table.device)[:, None]
    k = torch.arange(size, device=table.device)[None, :]
    return table[q - k + size - 1]


def _attention(x, p, name: str, num_heads: int, mode: str):
    """x [B, h, w, C] -> [B, h, w, C]: multi-head self-attention over the
    h * w tokens with the decomposed relative-position terms of the
    unscaled queries added to the logits."""
    B, h, w, C = x.shape
    d = C // num_heads
    qkv = _linear(x.reshape(B, h * w, C), p, name + ".qkv", mode)
    qkv = qkv.reshape(B, h * w, 3, num_heads, d)
    Rh = _rel_pos(h, p[name + ".rel_pos_h"])
    Rw = _rel_pos(w, p[name + ".rel_pos_w"])
    heads = []
    for i in range(num_heads):
        q, k, v = (qkv[:, :, j, i] for j in range(3))  # [B, h*w, d]
        logits = round_to(q * d ** -0.5, mode) @ round_to(k, mode).transpose(
            1, 2)
        rq = round_to(q.reshape(B, h, w, d), mode)
        rel_h = torch.einsum("bhwc,hkc->bhwk", rq, round_to(Rh, mode))
        rel_w = torch.einsum("bhwc,wkc->bhwk", rq, round_to(Rw, mode))
        logits = (logits.reshape(B, h, w, h, w) + rel_h[:, :, :, :, None]
                  + rel_w[:, :, :, None, :]).reshape(B, h * w, h * w)
        heads.append(round_to(logits.softmax(-1), mode) @ round_to(v, mode))
    out = torch.stack(heads, 2).reshape(B, h, w, C)  # heads in order
    return _linear(out, p, name + ".proj", mode)


def _windows(x, ws: int):
    """[B, H, W, C] -> [B * nW, ws, ws, C], zero-padded bottom and right
    to a multiple of ws; and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _unwindows(x, ws: int, padded, size):
    (Hp, Wp), (H, W) = padded, size
    B = x.shape[0] // (Hp // ws * Wp // ws)
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def _block(x, p, name: str, cfg: dict, window: int, mode: str):
    """A pre-norm transformer block: attention (in windows of `window`
    tokens a side, or over all tokens at 0), then the GELU MLP, each
    added to the residual."""
    y = _layer_norm(x, p, name + ".norm1")
    if window:
        H, W = y.shape[1:3]
        y, padded = _windows(y, window)
    y = _attention(y, p, name + ".attn", cfg["num_heads"], mode)
    if window:
        y = _unwindows(y, window, padded, (H, W))
    x = x + y
    y = _layer_norm(x, p, name + ".norm2")
    y = F.gelu(_linear(y, p, name + ".mlp.lin1", mode))
    return x + _linear(y, p, name + ".mlp.lin2", mode)


def _layer_norm_2d(x, p, name: str):
    """LayerNorm over the channels of [B, C, H, W]."""
    mu = x.mean(1, keepdim=True)
    var = (x - mu).pow(2).mean(1, keepdim=True)
    x = (x - mu) / torch.sqrt(var + EPS)
    return x * p[name + ".weight"][:, None, None] \
        + p[name + ".bias"][:, None, None]


@torch.no_grad()
def encode(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
           mode: str = "fp32") -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The image encoder on x [B, img, img, 3]: (features [B, g, g,
    out_chans], the outputs [B, g, g, embed_dim] of the global blocks in
    order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, ps = params, cfg["patch_size"]
    y = _conv(x.permute(0, 3, 1, 2), p["patch_embed.proj.weight"], mode,
              stride=ps) + p["patch_embed.proj.bias"][:, None, None]
    y = y.permute(0, 2, 3, 1) + p["pos_embed"]
    globals_ = set(cfg["global_attn_indexes"])
    interm = []
    for i in range(cfg["depth"]):
        window = 0 if i in globals_ else cfg["window_size"]
        y = _block(y, p, f"blocks.{i}", cfg, window, mode)
        if i in globals_:
            interm.append(y)
    y = _conv(y.permute(0, 3, 1, 2), p["neck.0.weight"], mode)
    y = _layer_norm_2d(y, p, "neck.1")
    y = _conv(y, p["neck.2.weight"], mode, padding=1)
    y = _layer_norm_2d(y, p, "neck.3")
    return y.permute(0, 2, 3, 1), interm
