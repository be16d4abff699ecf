"""Tiny MLP building blocks, initialised U(-1/sqrt(fan_in), 1/sqrt(fan_in))
(weights and biases, torch's Linear default) from an explicit generator:
  - MLP: a bias-free Linear stack with ReLU between layers (none on the
    last);
  - SkipConnMLP: a leaky-ReLU (slope 0.01) stack, optional biases; at each
    skip layer the original input is concatenated back in."""
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


class SkipConnMLP(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int, skip_layers=(), use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_layers = tuple(skip_layers)
        layers, fin = [], dim_in
        for l in range(num_layers):
            if l in self.skip_layers:
                fin += dim_in
            fout = dim_out if l == num_layers - 1 else dim_hidden
            lin = nn.Linear(fin, fout, bias=use_bias, device=device)
            uniform_fan_in_(lin.weight, fin, generator)
            if use_bias:
                uniform_fan_in_(lin.bias, fin, generator)
            layers.append(lin)
            fin = fout
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        x_in = x
        for l, lin in enumerate(self.layers):
            if l in self.skip_layers:
                x = torch.cat([x, x_in], dim=-1)
            x = lin(x)
            if l != len(self.layers) - 1:
                x = torch.nn.functional.leaky_relu(x, negative_slope=0.01)
        return x
