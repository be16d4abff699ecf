"""VGG16-LPIPS in plain PyTorch (the JAX package's train/lpips.py), the third
RGB metric of the stage-1 eval beside PSNR and SSIM.

As the `lpips` package's net='vgg': the input in [-1, 1], a fixed shift and
scale, the VGG16 conv trunk tapped after relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3, each tap unit-normalised over its channels, the
squared difference weighted by a non-negative 1x1 head, averaged over the
pixels and summed over the taps.  The convolutions are plain `F.conv2d`
(JAX's are XLA convolutions, not a Pallas kernel) and run in fp32 with
cuDNN's TF32 off whatever the caller set: TF32 moves the value by about
1e-3 relative.

Weights (`load_lpips_params`): an explicit `.npz` path, else
$SANERF_LPIPS_WEIGHTS, both in the format of scripts/convert_lpips.py
(`vgg/conv{b}_{i}/kernel` in flax's [kh, kw, in, out], `vgg/conv{b}_{i}/bias`,
`lin{k}`), which the JAX package reads too; else a random proxy
(`random_lpips_params`).  The port's proxy is drawn from a torch.Generator,
so its values are not those of JAX's flax PRNGKey(0) init: the two proxies
are different metrics (mode `torch-random-proxy` against JAX's
`flax-random-proxy`), each zero for identical images, symmetric and
monotone in distortion; carried over as `.npz`, one set of weights gives
the same value in both.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# fixed input normalisation (lpips.ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16: (block channels, convs a block); a tap after each block's last relu
_VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_TAP_CHANNELS = (64, 128, 256, 512, 512)

# torchvision vgg16 `features.{idx}` of the 13 convs, in order
_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _conv_names():
    return [f"conv{b + 1}_{i + 1}" for b, (_, n) in enumerate(_VGG_CFG)
            for i in range(n)]


class VGG16Taps(nn.Module):
    """The VGG16 conv trunk (torch layout, NCHW) returning the 5 LPIPS tap
    activations."""

    def __init__(self):
        super().__init__()
        convs, c_in = {}, 3
        for b, (ch, n) in enumerate(_VGG_CFG):
            for i in range(n):
                convs[f"conv{b + 1}_{i + 1}"] = nn.Conv2d(c_in, ch, 3,
                                                          padding=1)
                c_in = ch
        self.convs = nn.ModuleDict(convs)

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for b, (_, n) in enumerate(_VGG_CFG):
            for i in range(n):
                x = F.relu(self.convs[f"conv{b + 1}_{i + 1}"](x))
            taps.append(x)
            if b < len(_VGG_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


def _normalize(feat, eps: float = 1e-10):
    """Unit norm over the channels (lpips.normalize_tensor), NCHW."""
    return feat / (torch.sqrt((feat ** 2).sum(dim=1, keepdim=True)) + eps)


@torch.no_grad()
def vgg_from_params(params: Dict, device="cpu") -> VGG16Taps:
    """A VGG16Taps holding params['vgg'] (flax layout, numpy)."""
    vgg = VGG16Taps()
    for name in _conv_names():
        leaf = params["vgg"][name]
        conv = vgg.convs[name]
        # flax [kh, kw, in, out] -> torch [out, in, kh, kw]
        conv.weight.copy_(torch.as_tensor(
            np.asarray(leaf["kernel"], np.float32).transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.as_tensor(np.asarray(leaf["bias"], np.float32)))
    return vgg.to(device).eval().requires_grad_(False)


def make_lpips_fn(params: Dict, device="cpu"):
    """fn(pred, gt) -> the LPIPS distance (a 0-d tensor); pred and gt
    [H, W, 3] or [N, H, W, 3] in [0, 1] (numpy or tensors), on `device`."""
    device = torch.device(device)
    vgg = vgg_from_params(params, device)
    lins = [torch.as_tensor(np.asarray(w, np.float32), device=device)
            for w in params["lins"]]
    shift = torch.as_tensor(_SHIFT, device=device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=device).reshape(1, 3, 1, 1)

    @torch.no_grad()
    def lpips_fn(pred, gt):
        x = torch.as_tensor(pred, dtype=torch.float32, device=device)
        y = torch.as_tensor(gt, dtype=torch.float32, device=device)
        if x.dim() == 3:
            x, y = x[None], y[None]
        xy = torch.cat([x, y]).permute(0, 3, 1, 2)
        xy = ((xy * 2.0 - 1.0) - shift) / scale
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            taps = vgg(xy)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        n = x.shape[0]
        total = 0.0
        for t, w in zip(taps, lins):
            d = (_normalize(t[:n]) - _normalize(t[n:])) ** 2  # [N, C, h, w]
            val = (d * w.reshape(1, -1, 1, 1)).sum(dim=1)  # the 1x1 head
            total = total + val.mean(dim=(1, 2))
        return total.mean()

    return lpips_fn


# ---------------------------------------------------------------------------
# weights: {"vgg": {conv name: {"kernel" [kh, kw, in, out], "bias"}},
#           "lins": [C] x 5}, numpy float32
# ---------------------------------------------------------------------------

def convert_torch_lpips(vgg_sd: Dict, lin_sd: Dict) -> Dict:
    """The params of torch state dicts (tensors or numpy): vgg_sd in
    torchvision's `vgg16().features` layout (`{idx}.weight` [out, in, 3, 3],
    `{idx}.bias`; a `features.` prefix is taken too), lin_sd the lpips
    package's heads (`lin{k}.model.1.weight` [1, C, 1, 1], or
    `lins.{k}.model.1.weight`), clamped at >= 0 as lpips does at eval."""
    def get(sd, *names):
        for n in names:
            if n in sd:
                v = sd[n]
                return np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                  else v, np.float32)
        raise KeyError(f"none of {names} in state dict "
                       f"(keys: {sorted(sd)[:8]}...)")

    vgg = {}
    for name, idx in zip(_conv_names(), _TORCH_CONV_IDX):
        w = get(vgg_sd, f"{idx}.weight", f"features.{idx}.weight")
        vgg[name] = {"kernel": w.transpose(2, 3, 1, 0),
                     "bias": get(vgg_sd, f"{idx}.bias", f"features.{idx}.bias")}
    lins = []
    for tap, c in enumerate(_TAP_CHANNELS):
        w = get(lin_sd, f"lin{tap}.model.1.weight",
                f"lins.{tap}.model.1.weight").reshape(-1)
        if w.shape != (c,):
            raise ValueError(f"lin{tap}: {w.shape}, expected ({c},)")
        lins.append(np.maximum(w, 0.0))
    return {"vgg": vgg, "lins": lins}


def random_lpips_params(seed: int = 0) -> Dict:
    """The port's proxy: a random VGG16 (kernels N(0, 1 / fan_in), the
    variance of flax's lecun_normal, zero biases) drawn from a
    torch.Generator seeded `seed`, and uniform heads 1 / C."""
    g = torch.Generator().manual_seed(seed)
    vgg, c_in = {}, 3
    for b, (ch, n) in enumerate(_VGG_CFG):
        for i in range(n):
            k = torch.randn((3, 3, c_in, ch), generator=g) / np.sqrt(9 * c_in)
            vgg[f"conv{b + 1}_{i + 1}"] = {"kernel": k.numpy(),
                                           "bias": np.zeros(ch, np.float32)}
            c_in = ch
    lins = [np.full((c,), 1.0 / c, np.float32) for c in _TAP_CHANNELS]
    return {"vgg": vgg, "lins": lins}


def save_lpips_npz(path: str, params: Dict):
    flat = {f"vgg/{name}/{leaf}": np.asarray(v)
            for name, d in params["vgg"].items() for leaf, v in d.items()}
    for i, w in enumerate(params["lins"]):
        flat[f"lin{i}"] = np.asarray(w)
    np.savez(path, **flat)


def load_lpips_npz(path: str) -> Dict:
    vgg: Dict = {}
    lins = [None] * len(_TAP_CHANNELS)
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("vgg/"):
                _, name, leaf = key.split("/")
                vgg.setdefault(name, {})[leaf] = data[key]
            elif key.startswith("lin"):
                lins[int(key[3:])] = data[key]
    if any(w is None for w in lins):
        raise ValueError(f"{path}: missing lin heads")
    return {"vgg": vgg, "lins": lins}


def load_lpips_params(weights_path: Optional[str] = None):
    """(params, mode): an explicit path, else $SANERF_LPIPS_WEIGHTS, else
    the random proxy.  A path that names no file raises
    FileNotFoundError (JAX takes the proxy then)."""
    path = weights_path or os.environ.get("SANERF_LPIPS_WEIGHTS", "")
    if not path:
        return random_lpips_params(), "torch-random-proxy"
    if not os.path.exists(path):
        raise FileNotFoundError(f"LPIPS weights {path} not found")
    return load_lpips_npz(path), "torch-vgg16-ckpt"
