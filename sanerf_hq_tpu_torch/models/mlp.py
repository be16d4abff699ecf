"""Tiny MLP building block: a bias-free Linear stack with ReLU between
layers (none on the last).  Initialisation U(-1/sqrt(fan_in),
1/sqrt(fan_in)), drawn from an explicit generator."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def uniform_fan_in_(t: torch.Tensor, fan_in: int,
                    generator: Optional[torch.Generator] = None):
    bound = 1.0 / fan_in ** 0.5
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)
    return t


class MLP(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
        self.layers = nn.ModuleList(
            nn.Linear(dims[l], dims[l + 1], bias=False, device=device)
            for l in range(num_layers))
        for lin in self.layers:
            uniform_fan_in_(lin.weight, lin.in_features, generator)

    def forward(self, x):
        for l, lin in enumerate(self.layers):
            x = lin(x)
            if l != len(self.layers) - 1:
                x = torch.relu(x)
        return x
