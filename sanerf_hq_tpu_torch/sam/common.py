"""Shared blocks of the SAM port.

The module and parameter names are those of the released SAM / HQ-SAM
checkpoints, so `load_state_dict` takes them as they are (weights.py).
The modules take and return channels-last maps ([B, H, W, C]), as the JAX
package's do; the convolution stacks (nn.Sequential, whose indices are
the checkpoints') run on NCHW, and `conv_nhwc` permutes around them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x):
    """Exact (erf) GELU, torch's default and the checkpoints' activation
    (not the tanh form)."""
    return F.gelu(x)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW map, eps 1e-6 (the SAM
    necks' and decoders' LayerNorm2d)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):  # [B, C, H, W]
        mu = x.mean(1, keepdim=True)
        var = (x - mu).pow(2).mean(1, keepdim=True)
        x = (x - mu) / torch.sqrt(var + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def conv_nhwc(stack: nn.Module, x):
    """Run an NCHW convolution stack on a channels-last map."""
    return stack(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MLPBlock(nn.Module):
    def __init__(self, embedding_dim: int, mlp_dim: int, act=gelu):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class MLPHead(nn.Module):
    """Plain MLP of the mask decoder's hypernetworks and IoU head."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
