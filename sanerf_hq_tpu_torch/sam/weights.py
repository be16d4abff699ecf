"""SAM weights.  The port's module and parameter names are the released
checkpoints' (`image_encoder.blocks.{i}.attn.qkv.weight`,
`mask_decoder.compress_vit_feat.0.weight`, ...), so a checkpoint loads as
it is: `load_sam_checkpoint` reads it and `build_sam` calls
`load_state_dict(strict=True)` on it.  `sam_params_from_jax` turns the JAX
package's flax parameter tree (numpy leaves) into that state_dict, the
inverse of the JAX package's `convert_state_dict`:

  Linear           kernel [in, out]          -> weight [out, in]
  Conv2d           kernel [kh, kw, in, out]  -> weight [out, in, kh, kw]
  ConvTranspose2d  kernel [kh, kw, in, out], spatially flipped
                                             -> weight [in, out, kh, kw]
  LayerNorm        scale / bias              -> weight / bias
  LayerNorm2d      weight / bias             -> weight / bias
  Embedding        embedding                 -> weight
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_sam_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a released checkpoint, on the CPU (a file whose
    top level is {"model": state_dict} is unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v.float() for k, v in sd.items()}


def _lin(out, name, p):
    out[f"{name}.weight"] = p["kernel"].T
    if "bias" in p:
        out[f"{name}.bias"] = p["bias"]


def _conv(out, name, p):
    out[f"{name}.weight"] = p["kernel"].transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{name}.bias"] = p["bias"]


def _convT(out, name, p):
    out[f"{name}.weight"] = p["kernel"][::-1, ::-1].transpose(2, 3, 0, 1)
    if "bias" in p:
        out[f"{name}.bias"] = p["bias"]


def _ln(out, name, p):
    out[f"{name}.weight"] = p["scale"]
    out[f"{name}.bias"] = p["bias"]


def _ln2d(out, name, p):
    out[f"{name}.weight"] = p["weight"]
    out[f"{name}.bias"] = p["bias"]


def _emb(out, name, p):
    out[f"{name}.weight"] = p["embedding"]


def _mlp_head(out, name, p):
    for i in range(len(p)):
        _lin(out, f"{name}.layers.{i}", p[f"layers_{i}"])


def _attn_ds(out, name, p):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(out, f"{name}.{proj}", p[proj])


def _transformer(out, name, p):
    n_layers = sum(1 for k in p if k.startswith("layers_"))
    for i in range(n_layers):
        b, q = f"{name}.layers.{i}", p[f"layers_{i}"]
        for a in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            _attn_ds(out, f"{b}.{a}", q[a])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _ln(out, f"{b}.{n}", q[n])
        _lin(out, f"{b}.mlp.lin1", q["mlp"]["lin1"])
        _lin(out, f"{b}.mlp.lin2", q["mlp"]["lin2"])
    _attn_ds(out, f"{name}.final_attn_token_to_image",
             p["final_attn_token_to_image"])
    _ln(out, f"{name}.norm_final_attn", p["norm_final_attn"])


def sam_params_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """{"encoder", "prompt_encoder", "decoder"} flax parameters (numpy) ->
    the checkpoint-layout state_dict (numpy, contiguous float32).  An HQ
    decoder is told by its "base" subtree."""
    out: Dict[str, np.ndarray] = {}
    enc = tree["encoder"]
    e = "image_encoder"
    _conv(out, f"{e}.patch_embed.proj", enc["patch_embed_proj"])
    out[f"{e}.pos_embed"] = enc["pos_embed"]
    depth = sum(1 for k in enc if k.startswith("blocks_"))
    for i in range(depth):
        b, q = f"{e}.blocks.{i}", enc[f"blocks_{i}"]
        _ln(out, f"{b}.norm1", q["norm1"])
        _lin(out, f"{b}.attn.qkv", q["attn"]["qkv"])
        out[f"{b}.attn.rel_pos_h"] = q["attn"]["rel_pos_h"]
        out[f"{b}.attn.rel_pos_w"] = q["attn"]["rel_pos_w"]
        _lin(out, f"{b}.attn.proj", q["attn"]["proj"])
        _ln(out, f"{b}.norm2", q["norm2"])
        _lin(out, f"{b}.mlp.lin1", q["mlp"]["lin1"])
        _lin(out, f"{b}.mlp.lin2", q["mlp"]["lin2"])
    _conv(out, f"{e}.neck.0", enc["neck_conv1"])
    _ln2d(out, f"{e}.neck.1", enc["neck_ln1"])
    _conv(out, f"{e}.neck.2", enc["neck_conv2"])
    _ln2d(out, f"{e}.neck.3", enc["neck_ln2"])

    pe, p = tree["prompt_encoder"], "prompt_encoder"
    out[f"{p}.pe_layer.positional_encoding_gaussian_matrix"] = \
        pe["pe_layer"]["positional_encoding_gaussian_matrix"]
    for i in range(4):
        _emb(out, f"{p}.point_embeddings.{i}", pe[f"point_embeddings_{i}"])
    _emb(out, f"{p}.not_a_point_embed", pe["not_a_point_embed"])
    for i in (0, 3, 6):
        _conv(out, f"{p}.mask_downscaling.{i}", pe[f"mask_downscaling_{i}"])
    for i in (1, 4):
        _ln2d(out, f"{p}.mask_downscaling.{i}", pe[f"mask_downscaling_{i}"])
    _emb(out, f"{p}.no_mask_embed", pe["no_mask_embed"])

    dec, d = tree["decoder"], "mask_decoder"
    hq = "base" in dec
    base = dec["base"] if hq else dec
    _transformer(out, f"{d}.transformer", base["transformer"])
    _emb(out, f"{d}.iou_token", base["iou_token"])
    _emb(out, f"{d}.mask_tokens", base["mask_tokens"])
    _convT(out, f"{d}.output_upscaling.0", base["output_upscaling_0"])
    _ln2d(out, f"{d}.output_upscaling.1", base["output_upscaling_1"])
    _convT(out, f"{d}.output_upscaling.3", base["output_upscaling_3"])
    n_hyper = sum(1 for k in base if k.startswith("output_hypernetworks"))
    for i in range(n_hyper):
        _mlp_head(out, f"{d}.output_hypernetworks_mlps.{i}",
                  base[f"output_hypernetworks_mlps_{i}"])
    _mlp_head(out, f"{d}.iou_prediction_head", base["iou_prediction_head"])
    if hq:
        _emb(out, f"{d}.hf_token", dec["hf_token"])
        _mlp_head(out, f"{d}.hf_mlp", dec["hf_mlp"])
        for stack in ("compress_vit_feat", "embedding_encoder"):
            _convT(out, f"{d}.{stack}.0", dec[f"{stack}_0"])
            _ln2d(out, f"{d}.{stack}.1", dec[f"{stack}_1"])
            _convT(out, f"{d}.{stack}.3", dec[f"{stack}_3"])
        _conv(out, f"{d}.embedding_maskfeature.0",
              dec["embedding_maskfeature_0"])
        _ln2d(out, f"{d}.embedding_maskfeature.1",
              dec["embedding_maskfeature_1"])
        _conv(out, f"{d}.embedding_maskfeature.3",
              dec["embedding_maskfeature_3"])
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}
