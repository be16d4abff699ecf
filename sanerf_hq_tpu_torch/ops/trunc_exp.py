"""Truncated-gradient exponentials.

Forward is exp(x) in float32; backward is g * exp(clamp(x, -15, 15)) so huge
densities cannot blow up the gradient.
"""
import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


class _SafeTruncExp(torch.autograd.Function):
    """Forward clamps the input to [-30, 15] so sigma can never overflow to
    inf; backward matches trunc_exp."""

    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(x.clamp(-30.0, 15.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def safe_trunc_exp(x):
    return _SafeTruncExp.apply(x)
