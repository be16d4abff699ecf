"""Frequency (positional) encoding: [x, sin(2^k x), cos(2^k x)], channel-
major as the JAX package's ops/freq.py: for each input channel d, x_d then
(sin, cos) of 2^0 x_d .. 2^(degree-1) x_d.  Output dim = input_dim * (1 + 2 *
degree).  (K8's input, ops/fused_mlp.py `_freq`, lays the same features out
in its kernel's block order.)"""
import torch


def freq_encode(x, degree: int = 4):
    """x: [..., D] -> [..., D * (1 + 2 * degree)]."""
    parts = [x[..., :, None]]
    for k in range(degree):
        f = (2.0 ** k) * x
        parts += [torch.sin(f)[..., :, None], torch.cos(f)[..., :, None]]
    return torch.cat(parts, dim=-1).reshape(*x.shape[:-1], -1)


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)
