"""Render-level kernels, each a hand-written CUDA kernel with a plain
PyTorch twin beside its wrapper:
  K5 `fused_prop_level_sample`: proposal level + inverse-CDF resampling
     (inference); K1 `fused_prop_level_sample_train`: the same kernel that
     also writes the raw weights; K7 `fused_prop_level`: the same kernel
     writing the raw weights alone, with no resampling
     (csrc/render_level.cu);
  K3 `fused_final_level`: final level with CP line features, the inference
     and the training forward (csrc/render_level.cu), a sequence of three
     parts over all points, each with a wrapper and a plain version of its
     own: `final_level_inputs` (the trunk's layer-0 input), four
     `layer_product`s (the wgmma layer products K4 also runs,
     csrc/render_level_gemm.cuh) and `final_composite` (a warp a ray);
  K6 `fused_final_level_frozen`: K3 with no gradient that can also write
     each sample's trunk features, for a frozen backbone (the same launches
     with a geo pointer);
  K2 `fused_prop_level_bwd`, K4 `fused_final_level_bwd`: their weight grads
     (csrc/render_level_bwd.cu), each the composition of two parts with a
     wrapper and a plain version of its own: K2 `prop_level_bwd_partials`
     (a dW slab a CTA, summed on chip) and `reduce_partials` (their sum in
     CTA order); K4 `final_level_bwd_stash` (the weight products' bf16
     operands, plain version `final_level_bwd_operands`, and the CP basis
     grads) and `weight_grads` (the split-K GEMM dW = d^T x, plain version
     `weight_grads_ref`).
The training entry points are the autograd Functions `prop_level_train_sample`
(forward K1, backward K2), `prop_level_train` (forward K7, backward K2) and
`final_level_train` (forward K3, backward K4); gradients flow only to the
MLP weights and CP bases.

The wrappers keep the JAX names.  A CPU tensor goes to the plain twin, and
only a CPU tensor; a CUDA tensor launches the kernel or raises.  Each
wrapper counts its kernel launches in its `launches` attribute.

Weights are in the port's [out, in] layout.  The twins repeat the kernels'
arithmetic: bf16 operands emulated as `x.to(torch.bfloat16).float()`, fp32
sums, the sequential transmittance product, the resampling lookup against
the unnormalised running sum, and in the backward the closed-form
compositing backward with the reference's rounding points.  On the card
they need `torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's
default) to stay fp32.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_lib
from .contraction import contract
from .fused_mlp import _round16, bf16_round, trunk_input, trunk_with_inputs

GEO = 15  # geometry features the final level composites
SH_DIM = 16
CP_CHUNK = 1024  # K4's CP grads: points a partial sum (render_level_bwd.cu)


def _geometry(rays_o, rays_d, real_bins, grid_bound):
    """Midpoints t, widths and contracted / grid_bound positions [N, T, 3]."""
    t = (real_bins[:, :-1] + real_bins[:, 1:]) * 0.5
    delta = real_bins[:, 1:] - real_bins[:, :-1]
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    return t, delta, contract(xyz) / grid_bound


def _density(raw, db):
    return torch.exp((raw + db).clamp(-30.0, 15.0))


def _segment_trans(delta, sigma, s, opaque_last):
    """exp(-delta_s sigma_s); 0 for the opaque last sample."""
    T = delta.shape[1]
    if opaque_last and s == T - 1:
        return torch.zeros_like(sigma[:, s])
    return torch.exp(-delta[:, s] * sigma[:, s])


def _cp_lines(xn, cps, cp_res: int):
    """Linear-interp taps and line factors of the three CP axes: (lines
    [..., rank] x3, lower rows i0 [..., 3], upper weights f [..., 3]); `f`
    reaches 1 at the top edge."""
    p = ((xn + 1.0) * 0.5).clamp(0.0, 1.0) * (cp_res - 1)
    i0 = torch.floor(p).clamp(0.0, cp_res - 2.0)
    f = p - i0
    i0 = i0.long()
    lines = [cps[a][i0[..., a]] * (1.0 - f[..., a, None])
             + cps[a][i0[..., a] + 1] * f[..., a, None] for a in range(3)]
    return lines, i0, f


def cp_features(xn, cps, cp_res: int):
    """CP line features, product over axes: xn [..., 3] in [-1, 1], cps
    three [cp_res, rank] bases -> [..., rank].  A two-tap gather."""
    lines, _, _ = _cp_lines(xn, cps, cp_res)
    return lines[0] * lines[1] * lines[2]


def _trunk_input(xn, freq_degree: int, cps=(), cp_res: int = 0):
    """bf16-valued layer-0 input [freq(xn) | CP features] and the CP line
    factors and taps (None without CP)."""
    if not cps:
        return trunk_input(xn, freq_degree), None
    lines, i0, f = _cp_lines(xn, cps, cp_res)
    extra = lines[0] * lines[1] * lines[2]
    return trunk_input(xn, freq_degree, extra), (lines, i0, f)


# ---------------------------------------------------------------------------
# K5, K1 and K7: proposal level, with inverse-CDF resampling (K5), with the
# weights too (K1), or the weights alone (K7)
# ---------------------------------------------------------------------------

def prop_level_ref(rays_o, rays_d, real_bins, ws: Sequence, freq_degree: int,
                   grid_bound: float, opaque_last: bool = True,
                   density_bias: float = 0.0):
    """Plain twin of K7: the proposal level's raw per-sample weights
    [N, T] (no 0.01 floor)."""
    T = real_bins.shape[1] - 1
    _, delta, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    raw = trunk_with_inputs(_trunk_input(xn, freq_degree)[0], ws, -1)[0][..., 0]
    sigma = _density(raw, density_bias)
    trans = torch.ones_like(sigma[:, 0])
    w_raw = []
    for s in range(T):
        e = _segment_trans(delta, sigma, s, opaque_last)
        w_raw.append((1.0 - e) * trans)
        trans = trans * e
    return torch.stack(w_raw, dim=1)


def prop_level_train_sample_ref(rays_o, rays_d, real_bins, s_bins, u,
                                ws: Sequence, freq_degree: int,
                                grid_bound: float, opaque_last: bool = True,
                                density_bias: float = 0.0):
    """Plain twin of K1.  Returns (raw weights [N, T] without the 0.01
    floor, next s-space edges [N, Q]): K7's twin, then the resampling."""
    T = real_bins.shape[1] - 1
    w_raw = prop_level_ref(rays_o, rays_d, real_bins, ws, freq_degree,
                           grid_bound, opaque_last, density_bias)
    total = torch.zeros_like(w_raw[:, 0])
    w = []
    for s in range(T):
        w.append(w_raw[:, s] + 0.01)
        total = total + w[-1]
    c = [torch.zeros_like(total)]
    for s in range(T):
        c.append(torch.minimum(c[-1] + w[s], total))
    c = torch.stack(c, dim=1)  # [N, T+1], unnormalised cdf

    ut = u * total[:, None]
    le = c[:, None, :] <= ut[:, :, None]  # [N, Q, T+1]
    neg = torch.tensor(-1e38, device=c.device)
    pos = torch.tensor(1e38, device=c.device)
    c_g0 = torch.where(le, c[:, None, :], neg).amax(dim=-1)
    s_g0 = torch.where(le, s_bins[:, None, :], neg).amax(dim=-1)
    c_g1 = torch.minimum(torch.where(le, pos, c[:, None, :]).amin(dim=-1),
                         c[:, -1:])
    s_g1 = torch.minimum(torch.where(le, pos, s_bins[:, None, :]).amin(dim=-1),
                         s_bins[:, -1:])
    denom = c_g1 - c_g0
    t = torch.where(denom > 0,
                    (ut - c_g0) / torch.where(denom > 0, denom, 1.0), 0.0)
    return w_raw, s_g0 + t.clamp(0.0, 1.0) * (s_g1 - s_g0)


def prop_level_sample_ref(rays_o, rays_d, real_bins, s_bins, u,
                          ws: Sequence, freq_degree: int, grid_bound: float,
                          opaque_last: bool = True, density_bias: float = 0.0):
    """Plain twin of K5.  Returns the next level's s-space edges [N, Q]."""
    return prop_level_train_sample_ref(rays_o, rays_d, real_bins, s_bins, u,
                                       ws, freq_degree, grid_bound,
                                       opaque_last, density_bias)[1]


def _bf16_padded(w, rows: int, cols: int):
    return _pad2(w.to(torch.bfloat16), rows, cols)


def _check(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(source: str, name: str, n_ptr: int, n_int: int):
    """The C launch function `name` of csrc/<source>.cu with its argtypes:
    n_ptr pointers, n_int ints, then grid_bound, opaque_last, density_bias
    and the stream."""
    return _cfn(source, name, [_P] * n_ptr + [_I] * n_int + [_F, _I, _F, _P])


def _cfn(source: str, name: str, argtypes):
    """The C function `name` of csrc/<source>.cu with the given argtypes,
    returning an int."""
    lib = cuda_lib.load(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib, fn


def _sm_count(device) -> int:
    """Streaming multiprocessors of the card: the weight-grad GEMM sizes
    its split-K count by it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pad2(x, rows: int, cols: int):
    out = x.new_zeros((rows, cols))
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _device(x):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def _prop_weights(ws, freq_degree: int, dev, what: str):
    """Checks and bf16-pads the proposal weights as K1, K2 and K5 take
    them: w0 [H, KIN], w1 [H, H], w2 [16, H]."""
    if len(ws) != 3:
        raise ValueError(f"the {what} kernel takes a 3-layer proposal MLP")
    H, nf = ws[0].shape[0], 3 + 6 * freq_degree
    if H % 16 or H > 256:
        raise ValueError(f"unsupported {what} shape: hidden {H}")
    for name, x, shape in (("ws[0]", ws[0], (H, nf)), ("ws[1]", ws[1], (H, H)),
                           ("ws[2]", ws[2], (1, H))):
        _check(name, x, shape, dev)
    kin = _round16(nf)
    return (_bf16_padded(ws[0], H, kin), ws[1].to(torch.bfloat16).contiguous(),
            _bf16_padded(ws[2], 16, H)), H, kin


def _prop_launch_shape(N: int, T: int, Q: int, hidden: int, kin: int):
    """(grid, ray groups) of the proposal kernel at this shape: a CTA walks
    more than one group when groups > grid."""
    grid, groups = ctypes.c_int(0), ctypes.c_int(0)
    lib, fn = _cfn("render_level", "sanerf_prop_level_sample_shape",
                   [_I] * 5 + [_P, _P])
    cuda_lib.check(lib, fn(N, T, Q, hidden, kin, ctypes.byref(grid),
                           ctypes.byref(groups)), "the proposal kernel's shape")
    return grid.value, groups.value


def _launch_prop_sample(rays_o, rays_d, real_bins, s_bins, u, ws,
                        freq_degree, grid_bound, opaque_last, density_bias,
                        weights_out: bool, what: str):
    """K5 (weights_out False), K1, or K7 (s_bins and u None) on CUDA
    tensors: (weights or None, next s-edges or None)."""
    dev = _device(rays_o)
    resample = u is not None
    N, T = rays_o.shape[0], real_bins.shape[1] - 1
    Q = u.shape[1] if resample else 0
    if T < 1 or (resample and Q < 1):
        raise ValueError(f"unsupported {what} shape: T {T}, Q {Q}")
    checks = [("rays_o", rays_o, (N, 3)), ("rays_d", rays_d, (N, 3)),
              ("real_bins", real_bins, (N, T + 1))]
    if resample:
        checks += [("s_bins", s_bins, (N, T + 1)), ("u", u, (N, Q))]
    for name, x, shape in checks:
        _check(name, x, shape, dev)
    (w0, w1, w2), H, kin = _prop_weights(ws, freq_degree, dev, what)
    out = (torch.empty((N, Q), dtype=torch.float32, device=dev)
           if resample else None)
    weights = (torch.empty((N, T), dtype=torch.float32, device=dev)
               if weights_out else None)
    null = ctypes.c_void_p(0)
    lib, fn = _fn("render_level", "sanerf_prop_level_sample", 10, 6)
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins),
            _ptr(s_bins) if resample else null,
            _ptr(u) if resample else null, _ptr(w0), _ptr(w1), _ptr(w2),
            _ptr(out) if resample else null,
            null if weights is None else _ptr(weights), N, T,
            Q, freq_degree, H, kin, grid_bound, int(opaque_last),
            density_bias, _stream(dev))
    cuda_lib.check(lib, rc, what)
    return weights, out


def fused_prop_level_sample(rays_o, rays_d, real_bins, s_bins, u,
                            ws: Sequence, freq_degree: int,
                            grid_bound: float, opaque_last: bool = True,
                            density_bias: float = 0.0):
    """Proposal level + inverse-CDF resampling in one kernel (K5).

    rays_o, rays_d [N, 3]; real_bins, s_bins [N, T+1] (real and s-space
    edges of this level); u [N, Q] stratified queries; ws the three
    bias-free proposal weights [out, in] (last [1, hidden]).  Returns the
    next level's s-space edges [N, Q]; the per-sample weights stay on chip.
    """
    if rays_o.device.type == "cpu":
        return prop_level_sample_ref(rays_o, rays_d, real_bins, s_bins, u,
                                     ws, freq_degree, grid_bound,
                                     opaque_last, density_bias)
    _, out = _launch_prop_sample(rays_o, rays_d, real_bins, s_bins, u, ws,
                                 freq_degree, grid_bound, opaque_last,
                                 density_bias, False,
                                 "fused_prop_level_sample")
    fused_prop_level_sample.launches += 1
    return out


fused_prop_level_sample.launches = 0


def fused_prop_level_sample_train(rays_o, rays_d, real_bins, s_bins, u,
                                  ws: Sequence, freq_degree: int,
                                  grid_bound: float, opaque_last: bool = True,
                                  density_bias: float = 0.0):
    """K1: K5 that also writes the raw per-sample weights (no 0.01 floor)
    for the interlevel loss.  Returns (weights [N, T], next s-edges
    [N, Q])."""
    if rays_o.device.type == "cpu":
        return prop_level_train_sample_ref(rays_o, rays_d, real_bins, s_bins,
                                           u, ws, freq_degree, grid_bound,
                                           opaque_last, density_bias)
    out = _launch_prop_sample(rays_o, rays_d, real_bins, s_bins, u, ws,
                              freq_degree, grid_bound, opaque_last,
                              density_bias, True,
                              "fused_prop_level_sample_train")
    fused_prop_level_sample_train.launches += 1
    return out


fused_prop_level_sample_train.launches = 0


def fused_prop_level(rays_o, rays_d, real_bins, ws: Sequence,
                     freq_degree: int, grid_bound: float,
                     opaque_last: bool = True, density_bias: float = 0.0):
    """K7: the proposal level's raw per-sample weights [N, T] (no 0.01
    floor) with no resampling; K5's kernel with Q = 0.  rays_o, rays_d
    [N, 3]; real_bins [N, T+1]; ws the three bias-free proposal weights
    [out, in] (last [1, hidden])."""
    if rays_o.device.type == "cpu":
        return prop_level_ref(rays_o, rays_d, real_bins, ws, freq_degree,
                              grid_bound, opaque_last, density_bias)
    weights, _ = _launch_prop_sample(rays_o, rays_d, real_bins, None, None,
                                     ws, freq_degree, grid_bound,
                                     opaque_last, density_bias, True,
                                     "fused_prop_level")
    fused_prop_level.launches += 1
    return weights


fused_prop_level.launches = 0


# ---------------------------------------------------------------------------
# K3 and K6: final level with CP line features (K6 adds the trunk features)
# ---------------------------------------------------------------------------

def final_level_inputs_ref(rays_o, rays_d, real_bins, freq_degree: int,
                           grid_bound: float, cps: Sequence = (),
                           cp_res: int = 0):
    """Plain first part of K3: the trunk's layer-0 input h_in [N*T, 3 +
    6*deg + rank], bf16-valued fp32 ([freq | CP features]), and the
    contracted / grid_bound positions xn [N*T, 3]."""
    _, _, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    h_in, _ = _trunk_input(xn, freq_degree, cps, cp_res)
    return h_in.reshape(-1, h_in.shape[-1]), xn.reshape(-1, 3)


def layer_product_ref(x, w, relu: bool = True):
    """Plain version of one layer product: bf16(relu(x w^T)), bf16-valued
    fp32 (relu), or x w^T in fp32 (the last layer); x [P, k] bf16-valued,
    w [n, k] rounded to bf16."""
    y = x.float() @ bf16_round(w).t()
    return bf16_round(torch.relu(y)) if relu else y


def final_composite_ref(f, real_bins, sh, opaque_last: bool = True,
                        density_bias: float = 0.0, need_geo: bool = False):
    """Plain last part of K3: compositing of the trunk's outputs f [N*T, 16]
    (raw density | 15 features) with the sequential transmittance product.
    Returns (f_image [N, 31] = [sum w*features | wsum*sh], depth [N],
    weights_sum [N], weights [N, T], the features [N, T, 15] when need_geo
    or None)."""
    N, T = real_bins.shape[0], real_bins.shape[1] - 1
    h = f.reshape(N, T, f.shape[-1])
    t = (real_bins[:, :-1] + real_bins[:, 1:]) * 0.5
    delta = real_bins[:, 1:] - real_bins[:, :-1]
    sigma = _density(h[..., 0], density_bias)
    trans = torch.ones_like(sigma[:, 0])
    f_feat = torch.zeros_like(h[:, 0, 1:])
    depth = torch.zeros_like(trans)
    wsum = torch.zeros_like(trans)
    weights = []
    for s in range(T):
        e = _segment_trans(delta, sigma, s, opaque_last)
        w = (1.0 - e) * trans
        trans = trans * e
        f_feat = f_feat + w[:, None] * h[:, s, 1:]
        depth = depth + w * t[:, s]
        wsum = wsum + w
        weights.append(w)
    f_image = torch.cat([f_feat, wsum[:, None] * sh], dim=-1)
    geo = h[..., 1:] if need_geo else None
    return f_image, depth, wsum, torch.stack(weights, dim=1), geo


def final_level_frozen_ref(rays_o, rays_d, real_bins, sh, ws: Sequence,
                           freq_degree: int, skip_layer: int,
                           grid_bound: float, opaque_last: bool = True,
                           density_bias: float = 0.0, cps: Sequence = (),
                           cp_res: int = 0, need_geo: bool = False):
    """Plain twin of K6: final_level_ref, plus the trunk's per-sample
    features h[..., 1:] [N, T, 15] when need_geo (else None)."""
    _, _, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    h_in, _ = _trunk_input(xn, freq_degree, cps, cp_res)
    h, _ = trunk_with_inputs(h_in, ws, skip_layer)
    return final_composite_ref(h.reshape(-1, h.shape[-1]), real_bins, sh,
                               opaque_last, density_bias, need_geo)


def final_level_ref(rays_o, rays_d, real_bins, sh, ws: Sequence,
                    freq_degree: int, skip_layer: int, grid_bound: float,
                    opaque_last: bool = True, density_bias: float = 0.0,
                    cps: Sequence = (), cp_res: int = 0):
    """Plain twin of K3.  Returns (f_image [N, 15+16], depth [N],
    weights_sum [N], weights [N, T])."""
    return final_level_frozen_ref(rays_o, rays_d, real_bins, sh, ws,
                                  freq_degree, skip_layer, grid_bound,
                                  opaque_last, density_bias, cps, cp_res)[:4]


def _final_weights(ws, cps, cp_res, freq_degree, skip_layer, dev, what):
    """Checks and bf16-pads the trunk as K3, K6 and K4 take it: w0 [H, KIN],
    w1 [H, H], w2 [H, H+KIN] (columns [act | h_in]), w3 [16, H]."""
    rank = cps[0].shape[1] if cps else 0
    if len(ws) != 4 or skip_layer != 2:
        raise ValueError(f"the {what} kernel takes a 4-layer trunk with its "
                         "skip at layer 2")
    H, nin = ws[0].shape[0], 3 + 6 * freq_degree + rank
    kin = _round16(nin)
    if H % 16 or H > 256 or kin > 128 or (cps and cp_res < 2):
        raise ValueError(f"unsupported {what} shape: hidden {H}, input {nin}, "
                         f"cp_res {cp_res}")
    checks = [("ws[0]", ws[0], (H, nin)), ("ws[1]", ws[1], (H, H)),
              ("ws[2]", ws[2], (H, H + nin)), ("ws[3]", ws[3], (1 + GEO, H))]
    checks += [(f"cps[{a}]", c, (cp_res, rank)) for a, c in enumerate(cps)]
    for name, x, shape in checks:
        _check(name, x, shape, dev)
    padded = (_bf16_padded(ws[0], H, kin),
              ws[1].to(torch.bfloat16).contiguous(),
              _bf16_padded(ws[2], H, H + kin),
              ws[3].to(torch.bfloat16).contiguous())
    return padded, H, nin, kin, rank


def _final_rays(rays_o, rays_d, real_bins, dev, what, sh=None):
    """Checks the final level's ray inputs; returns (N, T)."""
    N, T = rays_o.shape[0], real_bins.shape[1] - 1
    if T < 1:
        raise ValueError(f"unsupported {what} shape: T {T}")
    checks = [("rays_o", rays_o, (N, 3)), ("rays_d", rays_d, (N, 3)),
              ("real_bins", real_bins, (N, T + 1))]
    if sh is not None:
        checks.append(("sh", sh, (N, SH_DIM)))
    for name, x, shape in checks:
        _check(name, x, shape, dev)
    return N, T


def _composite_outputs(N, T, need_geo, dev):
    """K3's outputs: f_image [N, 31], depth, wsum [N], weights [N, T], geo
    [N, T, 15] or None."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return (empty(N, GEO + SH_DIM), empty(N), empty(N), empty(N, T),
            empty(N, T, GEO) if need_geo else None)


def _launch_final(rays_o, rays_d, real_bins, sh, ws, freq_degree,
                  skip_layer, grid_bound, opaque_last, density_bias, cps,
                  cp_res, need_geo: bool, what: str):
    """K3 (need_geo False) or K6 on CUDA tensors: (f_image, depth,
    weights_sum, weights, geo or None).  The scratch the launches pass
    their activations through, P = N*T rows: xb [P, H+KIN] ([A2 | h_in]),
    a1, a3 [P, H] bf16; f [P, 16] (the last layer's output), xn [P, 3]
    fp32."""
    dev = _device(rays_o)
    (w0, w1, w2, w3), H, nin, kin, rank = _final_weights(
        ws, cps, cp_res, freq_degree, skip_layer, dev, what)
    N, T = _final_rays(rays_o, rays_d, real_bins, dev, what, sh)
    P = N * T
    xb, a1, a3 = torch.empty((P * (3 * H + kin),), dtype=torch.bfloat16,
                             device=dev).split([P * (H + kin), P * H, P * H])
    f, xn = torch.empty((P * 19,), dtype=torch.float32,
                        device=dev).split([P * 16, P * 3])
    outs = _composite_outputs(N, T, need_geo, dev)
    null = ctypes.c_void_p(0)
    cp_ptrs = [_ptr(c) for c in cps] if cps else [null] * 3
    lib, fn = _fn("render_level", "sanerf_final_level", 21, 7)
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(sh), _ptr(w0),
            _ptr(w1), _ptr(w2), _ptr(w3), *cp_ptrs,
            *(_ptr(x) for x in (xb, a1, a3, f, xn)),
            *(null if x is None else _ptr(x) for x in outs), N, T,
            freq_degree, rank, cp_res, H, kin, grid_bound, int(opaque_last),
            density_bias, _stream(dev))
    cuda_lib.check(lib, rc, what)
    return outs


def fused_final_level(rays_o, rays_d, real_bins, sh, ws: Sequence,
                      freq_degree: int, skip_layer: int, grid_bound: float,
                      opaque_last: bool = True, density_bias: float = 0.0,
                      cps: Sequence = (), cp_res: int = 0):
    """Final level (K3), one call launching its kernels: geometry, freq +
    CP features, the 4-layer trunk with its skip at layer 2 (four layer
    products over all points), and compositing.

    rays_o, rays_d [N, 3]; real_bins [N, T+1]; sh [N, 16] per-ray direction
    encoding; ws trunk weights [out, in]; cps three CP bases [cp_res, rank]
    (or none).  Returns (f_image [N, 31] = [sum w*geo15 | wsum*sh],
    depth [N], weights_sum [N], weights [N, T])."""
    if rays_o.device.type == "cpu":
        return final_level_ref(rays_o, rays_d, real_bins, sh, ws,
                               freq_degree, skip_layer, grid_bound,
                               opaque_last, density_bias, cps, cp_res)
    out = _launch_final(rays_o, rays_d, real_bins, sh, ws, freq_degree,
                        skip_layer, grid_bound, opaque_last, density_bias,
                        cps, cp_res, False, "fused_final_level")
    fused_final_level.launches += 1
    return out[:4]


fused_final_level.launches = 0


def fused_final_level_frozen(rays_o, rays_d, real_bins, sh, ws: Sequence,
                             freq_degree: int, skip_layer: int,
                             grid_bound: float, opaque_last: bool = True,
                             density_bias: float = 0.0, cps: Sequence = (),
                             cp_res: int = 0, need_geo: bool = False):
    """Frozen-backbone final level (K6), for the stage-2/3 side outputs:
    K3's fusion with no gradient.  Returns (f_image [N, 31], depth [N],
    weights_sum [N], weights [N, T], geo [N, T, 15] or None), geo being
    the per-sample trunk features the mask MLP reads (need_geo).

    The JAX function stop-gradients every input; here the caller detaches
    them (MLPField.fused_final_render_frozen does), and a weight that
    still requires grad while grad mode is on raises instead of silently
    losing its gradient."""
    if torch.is_grad_enabled():
        for name, x in [(f"ws[{i}]", w) for i, w in enumerate(ws)] + [
                (f"cps[{a}]", c) for a, c in enumerate(cps)]:
            if x.requires_grad:
                raise ValueError(
                    f"fused_final_level_frozen has no gradient: {name} "
                    "requires grad (detach it or use torch.no_grad)")
    if rays_o.device.type == "cpu":
        return final_level_frozen_ref(rays_o, rays_d, real_bins, sh, ws,
                                      freq_degree, skip_layer, grid_bound,
                                      opaque_last, density_bias, cps, cp_res,
                                      need_geo)
    out = _launch_final(rays_o, rays_d, real_bins, sh, ws, freq_degree,
                        skip_layer, grid_bound, opaque_last, density_bias,
                        cps, cp_res, need_geo, "fused_final_level_frozen")
    fused_final_level_frozen.launches += 1
    return out


fused_final_level_frozen.launches = 0


# The parts of K3 (and K6) alone, for the tests and the part timings; the
# kernel entry points above launch all three in one call.

def final_level_inputs(rays_o, rays_d, real_bins, freq_degree: int,
                       grid_bound: float, cps: Sequence = (), cp_res: int = 0,
                       hidden: int = 0):
    """K3's first kernel: (h_in, xn), the trunk's layer-0 input and the
    contracted / grid_bound positions of the N*T points.  On the card h_in
    is a bf16 view [P, KIN] (padding columns zero) of the scratch row
    [A2 | h_in] of width hidden + KIN that K3 gives the trunk.  On CPU
    tensors the plain part, final_level_inputs_ref."""
    if rays_o.device.type == "cpu":
        return final_level_inputs_ref(rays_o, rays_d, real_bins, freq_degree,
                                      grid_bound, cps, cp_res)
    dev = _device(rays_o)
    rank = cps[0].shape[1] if cps else 0
    kin = _round16(3 + 6 * freq_degree + rank)
    if hidden < 0 or hidden % 16 or (cps and cp_res < 2):
        raise ValueError(f"unsupported final_level_inputs shape: hidden "
                         f"{hidden}, cp_res {cp_res}")
    N, T = _final_rays(rays_o, rays_d, real_bins, dev, "final_level_inputs")
    for a, c in enumerate(cps):
        _check(f"cps[{a}]", c, (cp_res, rank), dev)
    xb = torch.empty((N * T, hidden + kin), dtype=torch.bfloat16, device=dev)
    xn = torch.empty((N * T, 3), dtype=torch.float32, device=dev)
    null = ctypes.c_void_p(0)
    cp_ptrs = [_ptr(c) for c in cps] if cps else [null] * 3
    lib, fn = _cfn("render_level", "sanerf_final_inputs",
                   [_P] * 8 + [_I] * 7 + [_F, _P])
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), *cp_ptrs, _ptr(xb),
            _ptr(xn), N, T, freq_degree, rank, cp_res, hidden, kin,
            grid_bound, _stream(dev))
    cuda_lib.check(lib, rc, "final_level_inputs")
    final_level_inputs.launches += 1
    return xb[:, hidden:], xn


final_level_inputs.launches = 0


def _check_rows(name, x, dtype, dev, rows, cols):
    """x must be a [rows, cols] `dtype` matrix on dev with unit column
    stride, a row stride that is a multiple of 8 and a 16-byte aligned
    start: what the layer product's 16-byte loads take."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != (rows, cols):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{(rows, cols)}")
    if x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous along its rows, with a "
                         f"row stride a multiple of 8 and a 16-byte aligned "
                         f"start; got stride {x.stride()}")


def layer_product(x, w, relu: bool = True):
    """One layer product of K3 (and K4), y = bf16(relu(x w^T)) as bf16
    (relu) or x w^T in fp32: the hand-written wgmma GEMM over all points
    (128 x 128 tiles, cp.async ring, two CTAs an SM).  x [P, k] bf16 (k a
    multiple of 16) and w [n, k] bf16 (n a multiple of 8), each with unit
    column stride, a row stride a multiple of 8 and a 16-byte aligned
    start.  On CPU tensors the plain version, layer_product_ref."""
    if x.device.type == "cpu":
        return layer_product_ref(x, w, relu)
    dev = _device(x)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError("layer_product takes matrices x [P, k], w [n, k]")
    (P, k), n = x.shape, w.shape[0]
    if k % 16 or n % 8 or k == 0 or n == 0:
        raise ValueError(f"unsupported layer_product shape: k {k}, n {n}")
    _check_rows("x", x, torch.bfloat16, dev, P, k)
    _check_rows("w", w, torch.bfloat16, dev, n, k)
    out = torch.empty((P, n), dtype=torch.bfloat16 if relu else torch.float32,
                      device=dev)
    null = ctypes.c_void_p(0)
    lib, fn = _cfn("render_level", "sanerf_layer_product",
                   [_P] * 4 + [ctypes.c_longlong] * 2 + [_I, ctypes.c_longlong]
                   + [_I] * 3 + [_P])
    rc = fn(_ptr(x), _ptr(w), _ptr(out) if relu else null,
            null if relu else _ptr(out), P, x.stride(0), w.stride(0), n, k, n,
            int(relu), _stream(dev))
    cuda_lib.check(lib, rc, "layer_product")
    layer_product.launches += 1
    return out


layer_product.launches = 0


def final_composite(f, real_bins, sh, opaque_last: bool = True,
                    density_bias: float = 0.0, need_geo: bool = False):
    """K3's last kernel: compositing of the trunk's outputs f [N*T, 16]
    fp32 (raw density | 15 features), a warp a ray, into (f_image [N, 31],
    depth [N], weights_sum [N], weights [N, T], geo [N, T, 15] or None).
    On CPU tensors the plain part, final_composite_ref."""
    if f.device.type == "cpu":
        return final_composite_ref(f, real_bins, sh, opaque_last,
                                   density_bias, need_geo)
    dev = _device(f)
    N, T = real_bins.shape[0], real_bins.shape[1] - 1
    if T < 1:
        raise ValueError(f"unsupported final_composite shape: T {T}")
    for name, x, shape in (("f", f, (N * T, 16)),
                           ("real_bins", real_bins, (N, T + 1)),
                           ("sh", sh, (N, SH_DIM))):
        _check(name, x, shape, dev)
    outs = _composite_outputs(N, T, need_geo, dev)
    null = ctypes.c_void_p(0)
    lib, fn = _cfn("render_level", "sanerf_final_composite",
                   [_P] * 8 + [_I] * 3 + [_F, _P])
    rc = fn(_ptr(f), _ptr(real_bins), _ptr(sh),
            *(null if x is None else _ptr(x) for x in outs), N, T,
            int(opaque_last), density_bias, _stream(dev))
    cuda_lib.check(lib, rc, "final_composite")
    final_composite.launches += 1
    return outs


final_composite.launches = 0


# ---------------------------------------------------------------------------
# K2 and K4: the weight grads of the proposal and the final level
# ---------------------------------------------------------------------------

def _compositing_bwd(raw, delta, G, opaque_last: bool, db: float):
    """Closed-form compositing backward (render_level_pallas.py:29):
    dL/d(ds_s) = G_s T_{s+1} - sum_{j>s} G_j w_j.  raw, delta, G [N, T]
    (G = dL/dw).  Returns (density grad [N, T], weights [N, T]): zero
    outside (-30, 15) and at the opaque last sample."""
    T = raw.shape[1]
    sigma = _density(raw, db)
    trans = torch.ones_like(raw[:, 0])
    w, Tn = [], []
    for s in range(T):
        e = _segment_trans(delta, sigma, s, opaque_last)
        w.append((1.0 - e) * trans)
        trans = trans * e
        Tn.append(trans)
    S = torch.zeros_like(trans)
    d_raw = [None] * T
    for s in range(T - 1, -1, -1):
        d_ds = G[:, s] * Tn[s] - S
        S = S + G[:, s] * w[s]
        x = raw[:, s] + db
        if opaque_last and s == T - 1:
            d_raw[s] = torch.zeros_like(x)
        else:
            d_raw[s] = torch.where((x > -30.0) & (x < 15.0),
                                   d_ds * delta[:, s] * sigma[:, s], 0.0)
    return torch.stack(d_raw, dim=1), torch.stack(w, dim=1)


def _trunk_bwd_operands(dh, ws, inputs, skip_layer: int, extra_rows: int):
    """Trunk backward with the kernels' rounding points, up to the weight
    products: dh [M, out] fp32 grad of the last layer's output, inputs the
    layers' inputs [M, in].  Returns (per-layer operands (d [M, out],
    x [M, in]), bf16-valued, with dW_l = d_l^T x_l; grad of the trailing
    extra_rows input columns [M, extra_rows] through layer 0 and the skip
    re-entry, or None)."""
    d = bf16_round(dh)
    pairs = [None] * len(ws)
    d_extra = None
    n_in0 = inputs[0].shape[1]
    for l in range(len(ws) - 1, -1, -1):
        pairs[l] = (d, inputs[l])
        if l == 0:
            if extra_rows:
                de = d @ bf16_round(ws[0])[:, -extra_rows:]
                d_extra = de if d_extra is None else d_extra + de
            break
        da = d @ bf16_round(ws[l])
        act = inputs[l]
        if l == skip_layer:
            rows = act.shape[1] - n_in0
            if extra_rows:
                de = da[:, rows + n_in0 - extra_rows:]
                d_extra = de if d_extra is None else d_extra + de
            da, act = da[:, :rows], act[:, :rows]
        d = bf16_round(torch.where(act > 0, da, 0.0))
    return pairs, d_extra


def weight_grads_ref(pairs):
    """Plain version of the weight-grad products: dW_l = d_l^T x_l [out,
    in] in fp32 from the per-layer operands (d [M, out], x [M, in])."""
    return [d.float().t() @ x.float() for d, x in pairs]


def prop_level_bwd_operands(rays_o, rays_d, real_bins, ws: Sequence, g_w,
                            freq_degree: int, grid_bound: float,
                            opaque_last: bool = True,
                            density_bias: float = 0.0):
    """Plain first part of K2: the per-layer operands (d [N*T, out],
    x [N*T, in]), bf16-valued fp32, whose products d^T x are the proposal
    weights' grads, from g_w = dL/dweights [N, T]."""
    _, delta, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    h, inputs = trunk_with_inputs(_trunk_input(xn, freq_degree)[0], ws, -1)
    d_raw, _ = _compositing_bwd(h[..., 0], delta, g_w, opaque_last,
                                density_bias)
    flat = [x.reshape(-1, x.shape[-1]) for x in inputs]
    return _trunk_bwd_operands(d_raw.reshape(-1, 1), ws, flat, -1, 0)[0]


def prop_level_bwd_ref(rays_o, rays_d, real_bins, ws: Sequence, g_w,
                       freq_degree: int, grid_bound: float,
                       opaque_last: bool = True, density_bias: float = 0.0):
    """Plain twin of K2: the proposal weights' grads [out, in] from
    g_w = dL/dweights [N, T]."""
    return weight_grads_ref(prop_level_bwd_operands(
        rays_o, rays_d, real_bins, ws, g_w, freq_degree, grid_bound,
        opaque_last, density_bias))


def _prop_slab(H: int, kin: int):
    """Sizes of K2's slab: dW0 [H, KIN] | dW1 [H, H] | dW2 [16, H]."""
    return H * kin, H * H, 16 * H


def prop_level_bwd_partials(rays_o, rays_d, real_bins, ws: Sequence, g_w,
                            freq_degree: int, grid_bound: float,
                            opaque_last: bool = True,
                            density_bias: float = 0.0):
    """K2's first kernel: partial weight grads [G, slab], one slab a CTA
    (dW0 [H, KIN] | dW1 [H, H] | dW2 [16, H], flattened and padded as the
    kernels take the weights), whose sum over G in order
    (`reduce_partials`) is the weights' grads.  On CPU tensors the plain
    version: the twin's grads as one slab [1, slab]."""
    if rays_o.device.type == "cpu":
        dws = prop_level_bwd_ref(rays_o, rays_d, real_bins, ws, g_w,
                                 freq_degree, grid_bound, opaque_last,
                                 density_bias)
        H, kin = ws[1].shape[0], _round16(ws[0].shape[1])
        return torch.cat([_pad2(dws[0], H, kin).flatten(),
                          dws[1].flatten(),
                          _pad2(dws[2], 16, H).flatten()])[None]
    dev = _device(rays_o)
    N, T = rays_o.shape[0], real_bins.shape[1] - 1
    (w0, w1, w2), H, kin = _prop_weights(ws, freq_degree, dev, "K2")
    if N == 0 or T < 1:
        raise ValueError(f"unsupported K2 shape: N {N}, T {T}")
    for name, x, shape in (("rays_o", rays_o, (N, 3)),
                           ("rays_d", rays_d, (N, 3)),
                           ("real_bins", real_bins, (N, T + 1)),
                           ("g_w", g_w, (N, T))):
        _check(name, x, shape, dev)
    # a slab a CTA: the kernel's own grid at this shape
    n_part = ctypes.c_int(0)
    lib, slabs = _cfn("render_level_bwd", "sanerf_prop_level_bwd_slabs",
                      [_I, _I, _I, _I, _P])
    cuda_lib.check(lib, slabs(N, T, H, kin, ctypes.byref(n_part)),
                   "prop_level_bwd_partials")
    part = torch.empty((n_part.value, sum(_prop_slab(H, kin))),
                       dtype=torch.float32, device=dev)
    lib, fn = _fn("render_level_bwd", "sanerf_prop_level_bwd", 8, 6)
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(w0), _ptr(w1),
            _ptr(w2), _ptr(g_w), _ptr(part), n_part.value, N, T,
            freq_degree, H, kin, grid_bound, int(opaque_last), density_bias,
            _stream(dev))
    cuda_lib.check(lib, rc, "prop_level_bwd_partials")
    prop_level_bwd_partials.launches += 1
    return part


prop_level_bwd_partials.launches = 0


def reduce_partials(part):
    """Sum of part [G, slab] over G in row order, fp32 (the second kernel of
    K2 and of K4's weight grads); on a CPU tensor `part.sum(0)`."""
    if part.device.type == "cpu":
        return part.sum(0)
    dev = _device(part)
    if part.dtype != torch.float32 or part.dim() != 2 or \
            not part.is_contiguous() or 0 in part.shape:
        raise ValueError("reduce_partials takes a non-empty contiguous "
                         f"float32 [G, slab], got {part.dtype} "
                         f"{tuple(part.shape)}")
    out = torch.empty((part.shape[1],), dtype=torch.float32, device=dev)
    lib, fn = _cfn("render_level_bwd", "sanerf_reduce_partials",
                   [_P, _P, _I, _I, _P])
    rc = fn(_ptr(part), _ptr(out), part.shape[0], part.shape[1], _stream(dev))
    cuda_lib.check(lib, rc, "reduce_partials")
    reduce_partials.launches += 1
    return out


reduce_partials.launches = 0


def fused_prop_level_bwd(rays_o, rays_d, real_bins, ws: Sequence, g_w,
                         freq_degree: int, grid_bound: float,
                         opaque_last: bool = True, density_bias: float = 0.0):
    """K2: the proposal weights' grads [out, in] (a list of 3) from
    g_w = dL/dweights [N, T] of K1's weights: `prop_level_bwd_partials`,
    then `reduce_partials`."""
    if rays_o.device.type == "cpu":
        return prop_level_bwd_ref(rays_o, rays_d, real_bins, ws, g_w,
                                  freq_degree, grid_bound, opaque_last,
                                  density_bias)
    part = prop_level_bwd_partials(rays_o, rays_d, real_bins, ws, g_w,
                                   freq_degree, grid_bound, opaque_last,
                                   density_bias)
    H, nf = ws[1].shape[0], 3 + 6 * freq_degree
    sizes = _prop_slab(H, _round16(nf))
    d0, d1, d2 = reduce_partials(part).split(sizes)
    fused_prop_level_bwd.launches += 1
    return [d0.view(H, -1)[:, :nf].contiguous(), d1.view(H, H),
            d2.view(16, H)[:1].contiguous()]


fused_prop_level_bwd.launches = 0


def final_level_bwd_ref(rays_o, rays_d, real_bins, sh, ws: Sequence, g_f,
                        g_depth, g_wsum, g_w, freq_degree: int,
                        skip_layer: int, grid_bound: float,
                        opaque_last: bool = True, density_bias: float = 0.0,
                        cps: Sequence = (), cp_res: int = 0):
    """Plain twin of K4: (trunk grads [out, in], CP basis grads
    [cp_res, rank]) from the grads of K3's four outputs."""
    pairs, dcps = final_level_bwd_operands(
        rays_o, rays_d, real_bins, sh, ws, g_f, g_depth, g_wsum, g_w,
        freq_degree, skip_layer, grid_bound, opaque_last, density_bias, cps,
        cp_res)
    return weight_grads_ref(pairs), dcps


def final_level_bwd_operands(rays_o, rays_d, real_bins, sh, ws: Sequence,
                             g_f, g_depth, g_wsum, g_w, freq_degree: int,
                             skip_layer: int, grid_bound: float,
                             opaque_last: bool = True,
                             density_bias: float = 0.0, cps: Sequence = (),
                             cp_res: int = 0):
    """Plain first part of K4: (per-layer operands (d [N*T, out],
    x [N*T, in]), bf16-valued fp32, whose products d^T x are the trunk
    grads; CP basis grads [cp_res, rank]) from the grads of K3's four
    outputs."""
    t, delta, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    h_in, cp = _trunk_input(xn, freq_degree, cps, cp_res)
    h, inputs = trunk_with_inputs(h_in, ws, skip_layer)
    g_sh = (g_f[:, GEO:] * sh).sum(dim=-1)
    dot = (g_f[:, None, :GEO] * h[..., 1:]).sum(dim=-1)
    G = (dot + g_sh[:, None] + g_depth[:, None] * t + g_wsum[:, None]) + g_w
    d_raw, w = _compositing_bwd(h[..., 0], delta, G, opaque_last,
                                density_bias)
    dh = torch.cat([d_raw[..., None], w[..., None] * g_f[:, None, :GEO]], -1)
    rank = cps[0].shape[1] if cps else 0
    flat = [x.reshape(-1, x.shape[-1]) for x in inputs]
    pairs, d_extra = _trunk_bwd_operands(dh.reshape(-1, dh.shape[-1]), ws,
                                         flat, skip_layer, rank)
    if not cps:
        return pairs, []
    lines, i0, f = cp
    lines = [x.reshape(-1, rank) for x in lines]
    i0, f = i0.reshape(-1, 3), f.reshape(-1, 3)
    d_lines = [d_extra * lines[1] * lines[2], d_extra * lines[0] * lines[2],
               d_extra * lines[0] * lines[1]]
    dcps = []
    for a in range(3):
        g = torch.zeros_like(cps[a])
        g.index_add_(0, i0[:, a], d_lines[a] * (1.0 - f[:, a, None]))
        g.index_add_(0, i0[:, a] + 1, d_lines[a] * f[:, a, None])
        dcps.append(g)
    return pairs, dcps


def final_level_bwd_stash(rays_o, rays_d, real_bins, sh, ws: Sequence, g_f,
                          g_depth, g_wsum, g_w, freq_degree: int,
                          skip_layer: int, grid_bound: float,
                          opaque_last: bool = True, density_bias: float = 0.0,
                          cps: Sequence = (), cp_res: int = 0):
    """K4's first kernel: (the trunk's weight-product operands [(d, x)] a
    layer, CP basis grads [cp_res, rank] (3 or none)) from the grads of
    K3's outputs, as final_level_bwd_operands.  On the card the operands
    are bf16 views of one stash in device memory, N*T rows, with the
    kernels' padded widths: x0 = h_in [KIN], x2 = [A2 | h_in] [H+KIN] (the
    same rows), padding columns zero; d3 [16].  On CPU tensors the plain
    version, final_level_bwd_operands."""
    if rays_o.device.type == "cpu":
        return final_level_bwd_operands(rays_o, rays_d, real_bins, sh, ws,
                                        g_f, g_depth, g_wsum, g_w,
                                        freq_degree, skip_layer, grid_bound,
                                        opaque_last, density_bias, cps,
                                        cp_res)
    dev = _device(rays_o)
    N, T = rays_o.shape[0], real_bins.shape[1] - 1
    (w0, w1, w2, w3), H, nin, kin, rank = _final_weights(
        ws, cps, cp_res, freq_degree, skip_layer, dev, "K4")
    if N == 0 or T < 1:
        raise ValueError(f"unsupported K4 shape: N {N}, T {T}")
    for name, x, shape in (("rays_o", rays_o, (N, 3)),
                           ("rays_d", rays_d, (N, 3)),
                           ("real_bins", real_bins, (N, T + 1)),
                           ("sh", sh, (N, SH_DIM)),
                           ("g_f", g_f, (N, GEO + SH_DIM)),
                           ("g_depth", g_depth, (N,)),
                           ("g_wsum", g_wsum, (N,)), ("g_w", g_w, (N, T))):
        _check(name, x, shape, dev)
    P = N * T
    widths = (H + kin, H, H, 16, H, H, H)  # xb, a1, a3, d3, d2, d1, d0
    stash = torch.empty((P * sum(widths),), dtype=torch.bfloat16, device=dev)
    xb, a1, a3, d3, d2, d1, d0 = (
        v.view(P, w) for v, w in zip(stash.split([P * w for w in widths]),
                                     widths))
    # fp32 scratch: the last layer's output [P, 16], the contracted
    # positions [P, 3] and the CP features' grad [P, rank]
    f, xn, e = torch.empty((P * (16 + 3 + rank),), dtype=torch.float32,
                           device=dev).split([P * 16, P * 3, P * rank])
    dcps = [torch.empty_like(c) for c in cps]
    # the CP grads of each chunk of CP_CHUNK points, summed in chunk order
    cp_part = (torch.empty((-(-P // CP_CHUNK) * 3 * cp_res * rank,),
                           dtype=torch.float32, device=dev) if rank else None)
    null = ctypes.c_void_p(0)
    cp_ptrs = [_ptr(c) for c in cps] if cps else [null] * 3
    dcp_ptrs = [_ptr(c) for c in dcps] if cps else [null] * 3
    # the dA products take the weights transposed, [in, out]
    wts = [w.t().contiguous() for w in (w0, w1, w2, w3)]
    lib, fn = _fn("render_level_bwd", "sanerf_final_level_bwd", 33, 7)
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(sh), _ptr(w0),
            _ptr(w1), _ptr(w2), _ptr(w3), *(_ptr(w) for w in wts), *cp_ptrs,
            _ptr(g_f), _ptr(g_depth),
            _ptr(g_wsum), _ptr(g_w), *(_ptr(x) for x in (xb, a1, a3, d3, d2,
                                                         d1, d0)),
            _ptr(f), _ptr(xn), _ptr(e) if rank else null, *dcp_ptrs,
            _ptr(cp_part) if rank else null, N, T,
            freq_degree, rank, cp_res, H, kin, grid_bound, int(opaque_last),
            density_bias, _stream(dev))
    cuda_lib.check(lib, rc, "final_level_bwd_stash")
    final_level_bwd_stash.launches += 1
    return [(d0, xb[:, H:]), (d1, a1), (d2, xb), (d3, a3)], dcps


final_level_bwd_stash.launches = 0


def _gemm_splits(pairs, device) -> int:
    """Split-K count of the weight-grad GEMM: as many as two CTAs an SM
    hold at once over all 128 x 128 output tiles (one wave), at least 1024
    points a split.  A function of the shapes and the card only, so the
    sums' order is the same on every run."""
    tiles = sum(-(-d.shape[1] // 128) * -(-x.shape[1] // 128)
                for d, x in pairs)
    points = pairs[0][0].shape[0]
    return max(1, min(2 * _sm_count(device) // tiles, -(-points // 1024)))


def weight_grads(pairs):
    """K4's second kernel: dW_l = d_l^T x_l [m, n] fp32 for up to four
    operand pairs (d [P, m], x [P, n]) over the same P points: a
    hand-written split-K GEMM (128 x 128 tiles, cp.async ring, wgmma) and
    the reduction of its splits in order, so the result is the same bits
    on every run.  On the card each operand is a bf16 matrix with unit
    column stride, a row stride that is a multiple of 8, a 16-byte aligned
    start and a multiple of 16 columns.  On CPU tensors the plain version,
    weight_grads_ref."""
    if pairs[0][0].device.type == "cpu":
        return weight_grads_ref(pairs)
    dev = _device(pairs[0][0])
    P = pairs[0][0].shape[0]
    if not 1 <= len(pairs) <= 4:
        raise ValueError(f"weight_grads takes 1 to 4 pairs, got {len(pairs)}")
    desc = []
    for i, (d, x) in enumerate(pairs):
        for name, t in (("d", d), ("x", x)):
            if t.device != dev or t.dtype != torch.bfloat16 or t.dim() != 2 \
                    or t.shape[0] != P or t.shape[1] % 16 or t.stride(1) != 1 \
                    or t.stride(0) % 8 or t.data_ptr() % 16:
                raise ValueError(
                    f"weight_grads: {name}{i} must be a bf16 [{P}, 16k] "
                    f"matrix on {dev} with unit column stride, a row stride "
                    f"a multiple of 8 and a 16-byte aligned start; got "
                    f"{t.dtype} {tuple(t.shape)} stride {t.stride()} on "
                    f"{t.device}")
        desc += [d.data_ptr(), x.data_ptr(), d.stride(0), x.stride(0),
                 d.shape[1], x.shape[1]]
    sizes = [d.shape[1] * x.shape[1] for d, x in pairs]
    splits = _gemm_splits(pairs, dev)
    part = torch.empty((splits, sum(sizes)), dtype=torch.float32, device=dev)
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    lib, fn = _cfn("render_level_bwd", "sanerf_weight_grads",
                   [_P, _I, ctypes.c_longlong, _I, _P, _P, _P])
    rc = fn((ctypes.c_longlong * len(desc))(*desc), len(pairs), P, splits,
            _ptr(part), _ptr(out), _stream(dev))
    cuda_lib.check(lib, rc, "weight_grads")
    weight_grads.launches += 1
    return [o.view(d.shape[1], x.shape[1])
            for o, (d, x) in zip(out.split(sizes), pairs)]


weight_grads.launches = 0


def fused_final_level_bwd(rays_o, rays_d, real_bins, sh, ws: Sequence, g_f,
                          g_depth, g_wsum, g_w, freq_degree: int,
                          skip_layer: int, grid_bound: float,
                          opaque_last: bool = True, density_bias: float = 0.0,
                          cps: Sequence = (), cp_res: int = 0):
    """K4: (trunk grads [out, in] (4), CP basis grads [cp_res, rank] (3 or
    none)) from g_f [N, 31], g_depth, g_wsum [N] and g_w [N, T], the grads
    of K3's outputs: `final_level_bwd_stash`, then `weight_grads`."""
    if rays_o.device.type == "cpu":
        return final_level_bwd_ref(rays_o, rays_d, real_bins, sh, ws, g_f,
                                   g_depth, g_wsum, g_w, freq_degree,
                                   skip_layer, grid_bound, opaque_last,
                                   density_bias, cps, cp_res)
    pairs, dcps = final_level_bwd_stash(rays_o, rays_d, real_bins, sh, ws,
                                        g_f, g_depth, g_wsum, g_w,
                                        freq_degree, skip_layer, grid_bound,
                                        opaque_last, density_bias, cps,
                                        cp_res)
    dw0, dw1, dw2, dw3 = weight_grads(pairs)
    H, nin = ws[1].shape[0], ws[0].shape[1]
    fused_final_level_bwd.launches += 1
    return [dw0[:, :nin].contiguous(), dw1, dw2[:, :H + nin].contiguous(),
            dw3], dcps


fused_final_level_bwd.launches = 0


# ---------------------------------------------------------------------------
# Training entry points: autograd Functions over the level kernels
# ---------------------------------------------------------------------------

class _PropLevelTrainSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rays_o, rays_d, real_bins, s_bins, u, static, *ws):
        weights, nxt = fused_prop_level_sample_train(
            rays_o, rays_d, real_bins, s_bins, u, ws, *static)
        ctx.save_for_backward(rays_o, rays_d, real_bins, *ws)
        ctx.static = static
        ctx.mark_non_differentiable(nxt)
        return weights, nxt

    @staticmethod
    def backward(ctx, g_w, _):
        rays_o, rays_d, real_bins, *ws = ctx.saved_tensors
        dws = fused_prop_level_bwd(rays_o, rays_d, real_bins, ws,
                                   g_w.contiguous(), *ctx.static)
        return (None,) * 6 + tuple(dws)


def prop_level_train_sample(rays_o, rays_d, real_bins, s_bins, u,
                            ws: Sequence, freq_degree: int,
                            grid_bound: float, opaque_last: bool = True,
                            density_bias: float = 0.0):
    """Differentiable proposal level with in-kernel resampling: forward K1,
    backward K2.  Returns (weights [N, T], next s-edges [N, Q]); grads flow
    to ws through the weights only (the bins are non-differentiable, as the
    reference detaches sample_pdf), never to rays, bins or u."""
    return _PropLevelTrainSample.apply(
        rays_o, rays_d, real_bins, s_bins, u,
        (freq_degree, grid_bound, opaque_last, density_bias), *ws)


class _PropLevelTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rays_o, rays_d, real_bins, static, *ws):
        weights = fused_prop_level(rays_o, rays_d, real_bins, ws, *static)
        ctx.save_for_backward(rays_o, rays_d, real_bins, *ws)
        ctx.static = static
        return weights

    @staticmethod
    def backward(ctx, g_w):
        rays_o, rays_d, real_bins, *ws = ctx.saved_tensors
        dws = fused_prop_level_bwd(rays_o, rays_d, real_bins, ws,
                                   g_w.contiguous(), *ctx.static)
        return (None,) * 4 + tuple(dws)


def prop_level_train(rays_o, rays_d, real_bins, ws: Sequence,
                     freq_degree: int, grid_bound: float,
                     opaque_last: bool = True, density_bias: float = 0.0):
    """Differentiable proposal level: forward K7, backward K2.  Returns the
    raw weights [N, T]; grads flow only to ws."""
    return _PropLevelTrain.apply(
        rays_o, rays_d, real_bins,
        (freq_degree, grid_bound, opaque_last, density_bias), *ws)


class _FinalLevelTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rays_o, rays_d, real_bins, sh, static, n_ws, *params):
        ws, cps = params[:n_ws], params[n_ws:]
        freq_degree, skip_layer, grid_bound, opaque_last, db, cp_res = static
        out = fused_final_level(rays_o, rays_d, real_bins, sh, ws,
                                freq_degree, skip_layer, grid_bound,
                                opaque_last, db, cps, cp_res)
        ctx.save_for_backward(rays_o, rays_d, real_bins, sh, *params)
        ctx.static, ctx.n_ws = static, n_ws
        return out

    @staticmethod
    def backward(ctx, g_f, g_depth, g_wsum, g_w):
        rays_o, rays_d, real_bins, sh, *params = ctx.saved_tensors
        ws, cps = params[:ctx.n_ws], params[ctx.n_ws:]
        freq_degree, skip_layer, grid_bound, opaque_last, db, cp_res = \
            ctx.static
        dws, dcps = fused_final_level_bwd(
            rays_o, rays_d, real_bins, sh, ws, g_f.contiguous(),
            g_depth.contiguous(), g_wsum.contiguous(), g_w.contiguous(),
            freq_degree, skip_layer, grid_bound, opaque_last, db, cps, cp_res)
        return (None,) * 6 + tuple(dws) + tuple(dcps)


def final_level_train(rays_o, rays_d, real_bins, sh, ws: Sequence,
                      freq_degree: int, skip_layer: int, grid_bound: float,
                      opaque_last: bool = True, density_bias: float = 0.0,
                      cps: Sequence = (), cp_res: int = 0):
    """Differentiable final level: forward K3, backward K4.  Returns
    (f_image [N, 31], depth [N], weights_sum [N], weights [N, T]); grads
    flow only to ws and cps."""
    return _FinalLevelTrain.apply(
        rays_o, rays_d, real_bins, sh,
        (freq_degree, skip_layer, grid_bound, opaque_last, density_bias,
         cp_res), len(ws), *ws, *cps)
