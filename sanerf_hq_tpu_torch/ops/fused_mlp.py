"""Frequency encoding + bias-free MLP forward: K8, a hand-written CUDA
kernel (csrc/fused_mlp.cu), with its plain PyTorch version beside it.

`fused_freq_mlp(x, ws, freq_degree, skip_layer)` is the composable route's
proposal MLPs and, without CP features, its trunk (models/mlp_field.py
`FreqMLP`).  It is an autograd Function: the forward launches K8 on a CUDA
tensor and runs `_reference_forward` on a CPU tensor, and only on a CPU
tensor; the backward re-runs `_reference_forward` under autograd, as the
JAX package's `_fused_bwd` differentiates its jnp reference.  The wrapper
counts its kernel launches in `fused_freq_mlp.launches`.  The JAX package
has two Pallas forms of this function, K8 (points on lanes) and K9 (points
on rows); their layouts are TPU VMEM choices, and the one CUDA kernel
computes both.

The plain versions are also the trunk of the level kernels' twins.  bf16
compute is emulated as `x.to(torch.bfloat16).float()` on both operands of
an fp32 matmul, which is exact for bf16 x bf16 products with fp32 sums.
Weights are [out, in].
"""
import ctypes

import torch

from . import cuda_lib


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


MAX_LAYERS = 8  # csrc/fused_mlp.cu MAXL


def _launch(x, ws, freq_degree: int, skip_layer: int):
    """K8 on CUDA tensors: x [B, D] fp32 contiguous and ws [out, in] fp32
    with one hidden width H -> [B, out] fp32.  The kernel takes each weight
    zero-padded to bf16 [rows, cols]: rows H, or the output width rounded
    up to 16 at the last layer; cols KIN (the layer-0 input width rounded up
    to 16) at layer 0, else H, and H + KIN at the skip layer, which reads
    [activation | layer-0 input]."""
    # render_level imports this module's plain versions when it loads
    from .render_level import _bf16_padded, _check, _ptr, _round16, _stream

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, D = x.shape
    L, nin = len(ws), D * (1 + 2 * freq_degree)
    H = ws[0].shape[0] if L > 1 else 16
    kin, out_dim = _round16(nin), ws[-1].shape[0]
    skip = skip_layer if 0 <= skip_layer < L else -1
    if (not 1 <= L <= MAX_LAYERS or skip == 0 or D < 1 or freq_degree < 0
            or H % 16 or H > 256 or kin > 256 or out_dim > 256):
        raise ValueError(
            f"unsupported fused_freq_mlp shape: {L} layers (1 to "
            f"{MAX_LAYERS}), skip layer {skip_layer} (not 0), hidden {H}, "
            f"input {nin}, output {out_dim}")
    _check("x", x, (B, D), dev)
    padded = []
    for l, w in enumerate(ws):
        rows = out_dim if l == L - 1 else H
        cols = (nin if l == 0 else H) + (nin if l == skip else 0)
        _check(f"ws[{l}]", w, (rows, cols), dev)
        # layer 0 and the skip layer (never the same) read the input once
        pad = kin - nin if l in (0, skip) else 0
        padded.append(_bf16_padded(w, _round16(rows), cols + pad))
    out = torch.empty((B, out_dim), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = cuda_lib.load("fused_mlp")
    fn = lib.sanerf_fused_freq_mlp
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    w_ptrs = (ctypes.c_void_p * L)(*(p.data_ptr() for p in padded))
    rc = fn(_ptr(x), _ptr(out), w_ptrs, L, B, D, freq_degree, H, kin,
            out_dim, skip, _stream(dev))
    cuda_lib.check(lib, rc, "fused_freq_mlp")
    fused_freq_mlp.launches += 1
    return out


def _forward(x, ws, freq_degree: int, skip_layer: int):
    if x.device.type == "cpu":
        return _reference_forward(x, ws, freq_degree, skip_layer)
    return _launch(x, ws, freq_degree, skip_layer)


class _FusedFreqMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, static, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.static = static
        return _forward(x, ws, *static)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        # needs_input_grad has a slot for `static` after x
        need = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[2:])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            y = _reference_forward(leaves[0], leaves[1:], *ctx.static)
            wanted = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(y, wanted, g))
        grads = [next(got) if n else None for n in need]
        return (grads[0], None, *grads[1:])


def fused_freq_mlp(x, ws, freq_degree: int, skip_layer: int = -1):
    """Frequency encoding + bias-free MLP (K8): x [..., D] fp32; ws the
    [out, in] weights, hidden layers of one width, layer `skip_layer`
    reading [activation | layer-0 input].  Returns [..., out] fp32; grads
    reach x and every weight through the plain version's autograd."""
    prefix = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _FusedFreqMLP.apply(x2, (freq_degree, skip_layer), *ws)
    return out.reshape(*prefix, out.shape[-1])


fused_freq_mlp.launches = 0
