"""Frequency encoding + bias-free MLP forward, plain PyTorch.

Only the plain versions are ported (the Pallas kernels K8/K9 are not):
they are the composable route's trunk and proposal MLPs and the trunk of
the level kernels' plain twins.  bf16 compute is emulated as
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


def trunk_input(x, freq_degree: int, extra=None):
    """bf16-valued layer-0 input: the block freq encoding of x, then the
    extra features (layout [freq(x) | extra])."""
    h = _freq(x.float(), freq_degree)
    if extra is not None:
        h = torch.cat([h, extra.float()], dim=-1)
    return bf16_round(h)


def trunk_with_inputs(h, ws, skip_layer: int):
    """Bias-free trunk on a bf16-valued fp32 input: hidden ReLU outputs are
    rounded to bf16, the last layer stays fp32, the skip concat re-uses the
    rounded layer-0 input.  Returns (output, each layer's input)."""
    h_in, inputs, n = h, [], len(ws)
    for l, w in enumerate(ws):
        if l == skip_layer:
            h = torch.cat([h, h_in], dim=-1)
        inputs.append(h)
        h = h @ bf16_round(w).t()
        if l != n - 1:
            h = bf16_round(torch.relu(h))
    return h, inputs


def _reference_forward(x, ws, freq_degree: int, skip_layer: int):
    return trunk_with_inputs(trunk_input(x, freq_degree), ws, skip_layer)[0]


def _reference_forward_with_extra(x, extra, ws, freq_degree: int,
                                  skip_layer: int):
    """_reference_forward with extra features appended to the freq
    encoding (layer-0 input layout [freq(x) | extra])."""
    return trunk_with_inputs(trunk_input(x, freq_degree, extra), ws,
                             skip_layer)[0]
