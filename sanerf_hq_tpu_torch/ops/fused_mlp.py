"""Frequency encoding + bias-free MLP forward, plain PyTorch.

Only the plain versions are ported in this slice: they are the composable
route's trunk and proposal MLPs.  bf16 compute is emulated as
`x.to(torch.bfloat16).float()` on both operands of an fp32 matmul, which is
exact for bf16 x bf16 products with fp32 sums.  Weights are [out, in].
"""
import torch


def bf16_round(x):
    """Round to bf16 and back: the value a bf16 operand holds."""
    return x.to(torch.bfloat16).float()


def _freq(x, degree: int):
    """Block-layout frequency encoding [x | sin(2^k x) | cos(2^k x)], each
    block k-major (row 3k+d holds octave k of channel d).  fp32 result."""
    f = torch.cat([x * (2.0 ** k) for k in range(degree)], dim=-1)
    return torch.cat([x, torch.sin(f), torch.cos(f)], dim=-1)


def _trunk(h, ws, skip_layer: int):
    """Bias-free trunk on a bf16-valued fp32 input: hidden ReLU outputs are
    rounded to bf16, the last layer stays fp32, the skip concat re-uses the
    rounded layer-0 input."""
    h_in = h
    n = len(ws)
    for l, w in enumerate(ws):
        if l == skip_layer:
            h = torch.cat([h, h_in], dim=-1)
        h = h @ bf16_round(w).t()
        if l != n - 1:
            h = bf16_round(torch.relu(h))
    return h


def _reference_forward(x, ws, freq_degree: int, skip_layer: int):
    return _trunk(bf16_round(_freq(x.float(), freq_degree)), ws, skip_layer)


def _reference_forward_with_extra(x, extra, ws, freq_degree: int,
                                  skip_layer: int):
    """_reference_forward with extra features appended to the freq
    encoding (layer-0 input layout [freq(x) | extra])."""
    h = torch.cat([_freq(x.float(), freq_degree), extra.float()], dim=-1)
    return _trunk(bf16_round(h), ws, skip_layer)
