"""Frequency encoding + bias-free MLP forward: K8, hand-written CUDA
(csrc/fused_mlp.cu) in two designs, with its plain PyTorch version beside
it.

`fused_freq_mlp(x, ws, freq_degree, skip_layer)` is the composable route's
proposal MLPs and, without CP features, its trunk (models/mlp_field.py
`FreqMLP`).  It is an autograd Function: the forward launches K8 on a CUDA
tensor and runs `_reference_forward` on a CPU tensor, and only on a CPU
tensor; the backward re-runs `_reference_forward` under autograd, as the
JAX package's `_fused_bwd` differentiates its jnp reference.  The wrapper
counts its calls into the library in `fused_freq_mlp.launches`.  The JAX
package has two Pallas forms of this function, K8 (points on lanes) and
K9 (points on rows); their layouts are TPU VMEM choices, and the one CUDA
entry point computes both.

`mlp_design` picks the design from the shape: "narrow" (one fused kernel
that reads the fp32 weights itself and keeps the activations in
registers: the proposal MLPs) or "wide" (a weight pack, an input kernel
and one wgmma product a layer over all points: the 256-wide trunk).
Either way the wrapper makes one call into the library.

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
MAX_WIDTH = 256  # hidden, layer-0 input (padded) and output widths
NARROW_MAX_HIDDEN = 64  # csrc/fused_mlp.cu NARROW_HT * 16
NARROW_WARPS, NARROW_POINTS = 8, 32  # a CTA's warps, a warp tile's points
NARROW_SMEM_MAX = 115712  # two CTAs an SM: 2 (bytes + 1 KiB) <= 228 KiB


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def layer_shapes(n_layers: int, hidden: int, nin: int, kin: int,
                 out_dim: int, skip: int):
    """(rows, cols_in, cols) of each layer's weights as the kernels take
    them: rows H (the last layer: out_dim); cols_in the [out, in]
    parameter's columns; cols the zero-padded bf16 width, KIN at layer 0,
    H + KIN at the skip layer ([activation | layer-0 input]), H elsewhere,
    the padding at the end of the row (csrc/fused_mlp.cu layer_shape)."""
    shapes = []
    for l in range(n_layers):
        act = 0 if l == 0 else hidden
        inp = l == 0 or l == skip
        shapes.append((out_dim if l == n_layers - 1 else hidden,
                       act + (nin if inp else 0), act + (kin if inp else 0)))
    return shapes


def narrow_smem_bytes(n_layers: int, hidden: int, nin: int, kin: int,
                      out_dim: int, skip: int) -> int:
    """Shared memory of K8's narrow kernel (csrc/fused_mlp.cu narrow_smem):
    each layer's bf16 weights [rows rounded up to 16, cols + 8] and each
    warp's input rows [32, KIN + 8]."""
    el = NARROW_WARPS * NARROW_POINTS * (kin + 8)
    for rows, _, cols in layer_shapes(n_layers, hidden, nin, kin, out_dim,
                                      skip):
        el += _round16(rows) * (cols + 8)
    return 2 * el


def mlp_design(n_layers: int, hidden: int, nin: int, kin: int, out_dim: int,
               skip: int) -> str:
    """K8's design at this shape: "narrow" (one fused kernel, the
    activations in registers) where a warp's hidden activations fit its
    registers (hidden <= 64; any width with one layer) and the bf16
    weights with the warps' input rows fit in shared memory with room for
    two CTAs an SM (<= 115,712 bytes); else "wide" (the input kernel and
    one wgmma product a layer over all points).  The 64 x 3 proposal MLPs
    (47,360 bytes) are narrow; the 256-wide trunk is wide; at hidden 64 and
    three layers the boundary lies between KIN 144 (narrow) and 160."""
    if n_layers > 1 and hidden > NARROW_MAX_HIDDEN:
        return "wide"
    smem = narrow_smem_bytes(n_layers, hidden, nin, kin, out_dim, skip)
    return "narrow" if smem <= NARROW_SMEM_MAX else "wide"


def packed_offsets(n_layers: int, hidden: int, nin: int, kin: int,
                   out_dim: int, skip: int):
    """Element offset of each layer in the wide design's packed bf16
    weights, and the total: layer l is [rows, cols] row-major at its
    offset (layer_shapes)."""
    offs = [0]
    for rows, _, cols in layer_shapes(n_layers, hidden, nin, kin, out_dim,
                                      skip):
        offs.append(offs[-1] + rows * cols)
    return offs


def pack_weights_ref(ws, nin: int, kin: int, skip: int):
    """Plain version of the wide design's weight pack: every layer's
    weights rounded to bf16 and zero-padded to [rows, cols]
    (layer_shapes), one after another in a flat bf16 tensor."""
    L, out_dim = len(ws), ws[-1].shape[0]
    hidden = ws[0].shape[0] if L > 1 else 16
    shapes = layer_shapes(L, hidden, nin, kin, out_dim, skip)
    offs = packed_offsets(L, hidden, nin, kin, out_dim, skip)
    buf = torch.zeros(offs[-1], dtype=torch.bfloat16, device=ws[0].device)
    for w, (rows, cin, cols), o in zip(ws, shapes, offs):
        buf[o:o + rows * cols].view(rows, cols)[:, :cin] = w
    return buf


def wide_plan(n_layers: int, skip: int):
    """Where the wide design writes each hidden layer's output: "xb" (the
    first H columns of the [P, H + KIN] input scratch, beside h_in) when
    the next layer is the skip layer, else "a" or "b", never the layer's
    own input (csrc/fused_mlp.cu sanerf_fused_freq_mlp_wide)."""
    plan, cur = [], None
    for l in range(n_layers - 1):
        cur = "xb" if l + 1 == skip else ("b" if cur == "a" else "a")
        plan.append(cur)
    return plan


def _mlp_shape(D: int, ws, freq_degree: int, skip_layer: int):
    """(L, nin, H, kin, out_dim, skip) of a call on D input channels,
    checked: the shapes every design takes."""
    L, nin = len(ws), D * (1 + 2 * freq_degree)
    H = ws[0].shape[0] if L > 1 else 16
    kin, out_dim = _round16(nin), ws[-1].shape[0]
    skip = skip_layer if 0 <= skip_layer < L else -1
    if (not 1 <= L <= MAX_LAYERS or skip == 0 or D < 1 or freq_degree < 0
            or H % 16 or H > MAX_WIDTH or kin > MAX_WIDTH
            or out_dim > MAX_WIDTH):
        raise ValueError(
            f"unsupported fused_freq_mlp shape: {L} layers (1 to "
            f"{MAX_LAYERS}), skip layer {skip_layer} (not 0), hidden {H}, "
            f"input {nin}, output {out_dim}")
    return L, nin, H, kin, out_dim, skip


def _check_weights(ws, shape, dev):
    from .render_level import _check

    for l, (w, (rows, cin, _)) in enumerate(zip(ws, layer_shapes(*shape))):
        _check(f"ws[{l}]", w, (rows, cin), dev)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _c_fn(name: str, argtypes):
    """The C function `name` of csrc/fused_mlp.cu with its argtypes,
    returning an int (0 or a cudaError_t code)."""
    lib = cuda_lib.load("fused_mlp")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib, fn


def _launch(x, ws, freq_degree: int, skip_layer: int):
    """K8 on CUDA tensors: x [B, D] fp32 contiguous and ws the fp32 [out,
    in] weights, contiguous, with one hidden width H -> [B, out] fp32.  One
    call into the library: the narrow kernel, or the wide design's
    launches (mlp_design)."""
    # render_level imports this module's plain versions when it loads
    from .render_level import _check, _stream

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, D = x.shape
    L, nin, H, kin, out_dim, skip = _mlp_shape(D, ws, freq_degree,
                                               skip_layer)
    _check("x", x, (B, D), dev)
    _check_weights(ws, (L, H, nin, kin, out_dim, skip), dev)
    out = torch.empty((B, out_dim), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    w_ptrs = (_P * L)(*(w.data_ptr() for w in ws))
    if mlp_design(L, H, nin, kin, out_dim, skip) == "narrow":
        lib, fn = _c_fn("sanerf_fused_freq_mlp_narrow",
                        [_P] * 3 + [_I] * 8 + [_P])
        rc = fn(x.data_ptr(), out.data_ptr(), w_ptrs, L, B, D, freq_degree,
                H, kin, out_dim, skip, _stream(dev))
    else:
        bf = dict(dtype=torch.bfloat16, device=dev)
        wpack = torch.empty(packed_offsets(L, H, nin, kin, out_dim, skip)[-1],
                            **bf)
        xb = torch.empty((B, (H if skip > 0 else 0) + kin), **bf)
        plan = wide_plan(L, skip)
        a, b = (torch.empty((B, H), **bf) if n in plan else None
                for n in "ab")
        lib, fn = _c_fn("sanerf_fused_freq_mlp_wide",
                        [_P] * 7 + [_I] * 8 + [_P])
        rc = fn(x.data_ptr(), out.data_ptr(), w_ptrs, wpack.data_ptr(),
                xb.data_ptr(), None if a is None else a.data_ptr(),
                None if b is None else b.data_ptr(), L, B, D, freq_degree, H,
                kin, out_dim, skip, _stream(dev))
    cuda_lib.check(lib, rc, "fused_freq_mlp")
    fused_freq_mlp.launches += 1
    return out


# The wide design's first two launches alone, for the tests and the part
# timings; fused_freq_mlp launches them within one call.

def pack_weights(ws, freq_degree: int, skip_layer: int = -1, D: int = 3):
    """The wide design's weight pack: a flat bf16 tensor holding each layer
    [rows, cols] zero-padded (layer_shapes, packed_offsets), made by one
    kernel launch from the fp32 weights.  On CPU tensors the plain version,
    pack_weights_ref."""
    from .render_level import _stream

    L, nin, H, kin, out_dim, skip = _mlp_shape(D, ws, freq_degree,
                                               skip_layer)
    if ws[0].device.type == "cpu":
        return pack_weights_ref(ws, nin, kin, skip)
    dev = ws[0].device
    _check_weights(ws, (L, H, nin, kin, out_dim, skip), dev)
    buf = torch.empty(packed_offsets(L, H, nin, kin, out_dim, skip)[-1],
                      dtype=torch.bfloat16, device=dev)
    lib, fn = _c_fn("sanerf_fused_freq_mlp_pack", [_P] * 2 + [_I] * 7 + [_P])
    rc = fn((_P * L)(*(w.data_ptr() for w in ws)), buf.data_ptr(), L, D,
            freq_degree, H, kin, out_dim, skip, _stream(dev))
    cuda_lib.check(lib, rc, "pack_weights")
    pack_weights.launches += 1
    return buf


pack_weights.launches = 0


def freq_input(x, freq_degree: int, c0: int = 0):
    """The wide design's input kernel: the bf16 layer-0 input [B, KIN]
    (padding columns zero), on the card a column view of a [B, c0 + KIN]
    scratch as the wide design's xb (c0 = H with a skip layer).  On CPU
    tensors the plain version, trunk_input padded to KIN."""
    from .render_level import _check, _stream

    B, D = x.shape
    kin = _round16(D * (1 + 2 * freq_degree))
    if x.device.type == "cpu":
        h = trunk_input(x, freq_degree)
        return torch.nn.functional.pad(h, (0, kin - h.shape[1])).to(
            torch.bfloat16)
    dev = x.device
    _check("x", x, (B, D), dev)
    if kin > MAX_WIDTH or c0 < 0 or c0 % 16:
        raise ValueError(f"unsupported freq_input shape: input {kin}, "
                         f"column {c0}")
    xb = torch.empty((B, c0 + kin), dtype=torch.bfloat16, device=dev)
    lib, fn = _c_fn("sanerf_fused_freq_mlp_input",
                    [_P, _P, ctypes.c_longlong] + [_I] * 4 + [_P])
    rc = fn(x.data_ptr(), xb[:, c0:].data_ptr(), c0 + kin, B, D, freq_degree,
            kin, _stream(dev))
    cuda_lib.check(lib, rc, "freq_input")
    freq_input.launches += 1
    return xb[:, c0:]


freq_input.launches = 0


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
