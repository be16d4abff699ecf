"""Metric meters with the reference's clear/update/measure/report protocol:
PSNR, SSIM (11x11 gaussian window, sigma 1.5, k1 0.01, k2 0.03, data range
1, valid convolution, as torchmetrics' default), LPIPS (VGG16; train/
lpips.py), MSE and the stage-3 mean IoU; and `pixel_accuracy`."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred, gt, data_range: float = 1.0):
    mse = torch.mean((torch.as_tensor(pred) - torch.as_tensor(gt)) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse / data_range ** 2, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5):
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, gt, data_range: float = 1.0, k1: float = 0.01,
         k2: float = 0.03):
    """pred, gt [H, W, C] in [0, data_range]: mean SSIM (fp32 depthwise
    convolutions; on the card they need cuDNN's TF32 off)."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    gt = torch.as_tensor(gt, dtype=torch.float32, device=pred.device)
    win = _gaussian_window().to(pred.device)[None, None]  # [1, 1, 11, 11]
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2

    def filt(img):  # [H, W, C] -> [C, H', W']
        return F.conv2d(img.permute(2, 0, 1)[:, None], win)[:, 0]

    mu_p, mu_g = filt(pred), filt(gt)
    var_p = filt(pred * pred) - mu_p ** 2
    var_g = filt(gt * gt) - mu_g ** 2
    cov = filt(pred * gt) - mu_p * mu_g
    s = ((2 * mu_p * mu_g + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_g ** 2 + c1) * (var_p + var_g + c2))
    return s.mean()


class Meter:
    name = "meter"
    higher_better = True

    def __init__(self):
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds, truths):
        raise NotImplementedError

    def measure(self):
        return self.V / max(self.N, 1)

    def report(self):
        return f"{self.name} = {self.measure():.6f}"


class PSNRMeter(Meter):
    name = "PSNR"

    def update(self, preds, truths):
        self.V += float(psnr(preds, truths))
        self.N += 1


class SSIMMeter(Meter):
    name = "SSIM"

    def update(self, preds, truths):
        p, t = torch.as_tensor(preds), torch.as_tensor(truths)
        if p.dim() == 3:
            p, t = p[None], t[None]
        for i in range(p.shape[0]):
            self.V += float(ssim(p[i], t[i]))
            self.N += 1


class LPIPSMeter(Meter):
    """VGG-LPIPS, lower is better.  Backends in JAX's order: the `lpips`
    package where it imports; else VGG16 weights in the `.npz` format of
    scripts/convert_lpips.py (`weights_path`, else $SANERF_LPIPS_WEIGHTS;
    a path that names no file raises); else the seeded random proxy
    (train/lpips.py).  `.mode` names the
    backend; `device` defaults to the card."""
    name = "LPIPS"
    higher_better = False

    def __init__(self, net: str = "vgg", weights_path=None, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        try:
            import lpips  # noqa: F401
        except ImportError:
            from .lpips import load_lpips_params, make_lpips_fn

            params, self.mode = load_lpips_params(weights_path)
            self._fn = make_lpips_fn(params, self.device)
        else:
            self.mode = "torch-lpips"
            net_ = lpips.LPIPS(net=net).eval().to(self.device)

            @torch.no_grad()
            def fn(pred, gt):
                p, t = (torch.as_tensor(a, dtype=torch.float32,
                                        device=self.device)
                        .permute(2, 0, 1)[None] for a in (pred, gt))
                return net_(p * 2 - 1, t * 2 - 1)

            self._fn = fn
        super().__init__()

    @property
    def available(self):
        return True

    def report(self):
        return f"{self.name}[{self.mode}] = {self.measure():.6f}"

    def update(self, preds, truths):
        self.V += float(self._fn(preds, truths))
        self.N += 1


class MSEMeter(Meter):
    name = "MSE"
    higher_better = False

    def update(self, preds, truths):
        d = torch.as_tensor(preds) - torch.as_tensor(truths)
        self.V += float(torch.mean(d ** 2))
        self.N += 1


class MeanIoUMeter(Meter):
    """Per-class IoU over the classes present in the truth (label -1 is
    ignored), averaged over classes, then over views.  preds and truths
    are integer label maps."""
    name = "MeanIoU"

    def update(self, preds, truths):
        p = np.asarray(preds).reshape(-1)
        t = np.asarray(truths).reshape(-1)
        valid = t != -1
        p, t = p[valid], t[valid]
        ious = []
        for cls in np.unique(t):
            union = np.logical_or(p == cls, t == cls).sum()
            if union > 0:
                ious.append(np.logical_and(p == cls, t == cls).sum() / union)
        if ious:
            self.V += float(np.mean(ious))
            self.N += 1


def pixel_accuracy(pred, gt, ignore=-1) -> float:
    """The share of pixels whose label equals the truth's, over the pixels
    whose truth is not `ignore` (0 when there are none)."""
    p = np.asarray(pred).reshape(-1)
    t = np.asarray(gt).reshape(-1)
    valid = t != ignore
    if valid.sum() == 0:
        return 0.0
    return float((p[valid] == t[valid]).mean())
