"""Metric meters with the reference's clear/update/measure/report protocol
(PSNR only in this slice)."""
from __future__ import annotations

import torch


def psnr(pred, gt, data_range: float = 1.0):
    mse = torch.mean((torch.as_tensor(pred) - torch.as_tensor(gt)) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse / data_range ** 2, min=1e-12))


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
