"""Render-level kernels, each a hand-written CUDA kernel with a plain
PyTorch twin beside its wrapper:
  K5 `fused_prop_level_sample`: proposal level + inverse-CDF resampling
     (inference); K1 `fused_prop_level_sample_train`: the same kernel that
     also writes the raw weights; K7 `fused_prop_level`: the same kernel
     writing the raw weights alone, with no resampling
     (csrc/render_level.cu);
  K3 `fused_final_level`: final level with CP line features, the inference
     and the training forward (csrc/render_level.cu);
  K6 `fused_final_level_frozen`: K3 with no gradient that can also write
     each sample's trunk features, for a frozen backbone (the same kernel
     with a geo pointer);
  K2 `fused_prop_level_bwd`, K4 `fused_final_level_bwd`: their weight grads
     (csrc/render_level_bwd.cu).
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
from .fused_mlp import bf16_round, trunk_input, trunk_with_inputs

GEO = 15  # geometry features the final level composites
SH_DIM = 16


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


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _bf16_padded(w, rows: int, cols: int):
    out = torch.zeros((rows, cols), dtype=torch.bfloat16, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w
    return out


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
    lib = cuda_lib.load(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_F, _I, _F, _P]
        fn.restype = _I
    return lib, fn


def _max_ctas(device) -> int:
    """CTAs of the backward kernels: one per SM, each with its own dW slab."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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

def final_level_frozen_ref(rays_o, rays_d, real_bins, sh, ws: Sequence,
                           freq_degree: int, skip_layer: int,
                           grid_bound: float, opaque_last: bool = True,
                           density_bias: float = 0.0, cps: Sequence = (),
                           cp_res: int = 0, need_geo: bool = False):
    """Plain twin of K6: final_level_ref, plus the trunk's per-sample
    features h[..., 1:] [N, T, 15] when need_geo (else None)."""
    T = real_bins.shape[1] - 1
    t, delta, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    h_in, _ = _trunk_input(xn, freq_degree, cps, cp_res)
    h, _ = trunk_with_inputs(h_in, ws, skip_layer)
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


def _launch_final(rays_o, rays_d, real_bins, sh, ws, freq_degree,
                  skip_layer, grid_bound, opaque_last, density_bias, cps,
                  cp_res, need_geo: bool, what: str):
    """K3 (need_geo False) or K6 on CUDA tensors: (f_image, depth,
    weights_sum, weights, geo or None)."""
    dev = _device(rays_o)
    N, T = rays_o.shape[0], real_bins.shape[1] - 1
    (w0, w1, w2, w3), H, nin, kin, rank = _final_weights(
        ws, cps, cp_res, freq_degree, skip_layer, dev, what)
    if T < 1:
        raise ValueError(f"unsupported {what} shape: T {T}")
    for name, x, shape in (("rays_o", rays_o, (N, 3)),
                           ("rays_d", rays_d, (N, 3)),
                           ("real_bins", real_bins, (N, T + 1)),
                           ("sh", sh, (N, SH_DIM))):
        _check(name, x, shape, dev)
    f_image = torch.empty((N, GEO + SH_DIM), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    wsum = torch.empty((N,), dtype=torch.float32, device=dev)
    weights = torch.empty((N, T), dtype=torch.float32, device=dev)
    geo = (torch.empty((N, T, GEO), dtype=torch.float32, device=dev)
           if need_geo else None)
    null = ctypes.c_void_p(0)
    cp_ptrs = [_ptr(c) for c in cps] if cps else [null] * 3
    lib, fn = _fn("render_level", "sanerf_final_level", 16, 7)
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(sh), _ptr(w0),
            _ptr(w1), _ptr(w2), _ptr(w3), *cp_ptrs, _ptr(f_image),
            _ptr(depth), _ptr(wsum), _ptr(weights),
            null if geo is None else _ptr(geo), N, T, freq_degree, rank,
            cp_res, H, kin, grid_bound, int(opaque_last), density_bias,
            _stream(dev))
    cuda_lib.check(lib, rc, what)
    return f_image, depth, wsum, weights, geo


def fused_final_level(rays_o, rays_d, real_bins, sh, ws: Sequence,
                      freq_degree: int, skip_layer: int, grid_bound: float,
                      opaque_last: bool = True, density_bias: float = 0.0,
                      cps: Sequence = (), cp_res: int = 0):
    """Final level in one kernel (K3): geometry, freq + CP features, the
    4-layer trunk with its skip at layer 2, and compositing.

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


def _trunk_bwd(dh, ws, inputs, skip_layer: int, extra_rows: int):
    """Trunk backward with the kernels' rounding points: dh [M, out] fp32
    grad of the last layer's output, inputs the layers' inputs [M, in].
    Returns (dW list [out, in], grad of the trailing extra_rows input
    columns [M, extra_rows] through layer 0 and the skip re-entry, or
    None)."""
    d = bf16_round(dh)
    dws = [None] * len(ws)
    d_extra = None
    n_in0 = inputs[0].shape[1]
    for l in range(len(ws) - 1, -1, -1):
        dws[l] = d.t() @ inputs[l]
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
    return dws, d_extra


def prop_level_bwd_ref(rays_o, rays_d, real_bins, ws: Sequence, g_w,
                       freq_degree: int, grid_bound: float,
                       opaque_last: bool = True, density_bias: float = 0.0):
    """Plain twin of K2: the proposal weights' grads [out, in] from
    g_w = dL/dweights [N, T]."""
    _, delta, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    h, inputs = trunk_with_inputs(_trunk_input(xn, freq_degree)[0], ws, -1)
    d_raw, _ = _compositing_bwd(h[..., 0], delta, g_w, opaque_last,
                                density_bias)
    flat = [x.reshape(-1, x.shape[-1]) for x in inputs]
    return _trunk_bwd(d_raw.reshape(-1, 1), ws, flat, -1, 0)[0]


def fused_prop_level_bwd(rays_o, rays_d, real_bins, ws: Sequence, g_w,
                         freq_degree: int, grid_bound: float,
                         opaque_last: bool = True, density_bias: float = 0.0):
    """K2: the proposal weights' grads [out, in] (a list of 3) from
    g_w = dL/dweights [N, T] of K1's weights."""
    if rays_o.device.type == "cpu":
        return prop_level_bwd_ref(rays_o, rays_d, real_bins, ws, g_w,
                                  freq_degree, grid_bound, opaque_last,
                                  density_bias)
    dev = _device(rays_o)
    N, T = rays_o.shape[0], real_bins.shape[1] - 1
    (w0, w1, w2), H, kin = _prop_weights(ws, freq_degree, dev, "K2")
    nf = 3 + 6 * freq_degree
    if N == 0 or T < 1:
        raise ValueError(f"unsupported K2 shape: N {N}, T {T}")
    for name, x, shape in (("rays_o", rays_o, (N, 3)),
                           ("rays_d", rays_d, (N, 3)),
                           ("real_bins", real_bins, (N, T + 1)),
                           ("g_w", g_w, (N, T))):
        _check(name, x, shape, dev)
    sizes = (H * kin, H * H, 16 * H)
    ctas = _max_ctas(dev)
    part = torch.empty((ctas, sum(sizes)), dtype=torch.float32, device=dev)
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    lib, fn = _fn("render_level_bwd", "sanerf_prop_level_bwd", 9, 6)
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(w0), _ptr(w1),
            _ptr(w2), _ptr(g_w), _ptr(part), _ptr(out), ctas, N, T,
            freq_degree, H, kin, grid_bound, int(opaque_last), density_bias,
            _stream(dev))
    cuda_lib.check(lib, rc, "fused_prop_level_bwd")
    fused_prop_level_bwd.launches += 1
    d0, d1, d2 = out.split(sizes)
    return [d0.view(H, kin)[:, :nf].contiguous(), d1.view(H, H),
            d2.view(16, H)[:1].contiguous()]


fused_prop_level_bwd.launches = 0


def final_level_bwd_ref(rays_o, rays_d, real_bins, sh, ws: Sequence, g_f,
                        g_depth, g_wsum, g_w, freq_degree: int,
                        skip_layer: int, grid_bound: float,
                        opaque_last: bool = True, density_bias: float = 0.0,
                        cps: Sequence = (), cp_res: int = 0):
    """Plain twin of K4: (trunk grads [out, in], CP basis grads
    [cp_res, rank]) from the grads of K3's four outputs."""
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
    dws, d_extra = _trunk_bwd(dh.reshape(-1, dh.shape[-1]), ws, flat,
                              skip_layer, rank)
    if not cps:
        return dws, []
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
    return dws, dcps


def fused_final_level_bwd(rays_o, rays_d, real_bins, sh, ws: Sequence, g_f,
                          g_depth, g_wsum, g_w, freq_degree: int,
                          skip_layer: int, grid_bound: float,
                          opaque_last: bool = True, density_bias: float = 0.0,
                          cps: Sequence = (), cp_res: int = 0):
    """K4: (trunk grads [out, in] (4), CP basis grads [cp_res, rank] (3 or
    none)) from g_f [N, 31], g_depth, g_wsum [N] and g_w [N, T], the grads
    of K3's outputs."""
    if rays_o.device.type == "cpu":
        return final_level_bwd_ref(rays_o, rays_d, real_bins, sh, ws, g_f,
                                   g_depth, g_wsum, g_w, freq_degree,
                                   skip_layer, grid_bound, opaque_last,
                                   density_bias, cps, cp_res)
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
    sizes = (H * kin, H * H, H * (H + kin), 16 * H)
    ctas = _max_ctas(dev)
    part = torch.empty((ctas, sum(sizes)), dtype=torch.float32, device=dev)
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    dcps = [torch.zeros_like(c) for c in cps]
    null = ctypes.c_void_p(0)
    cp_ptrs = [_ptr(c) for c in cps] if cps else [null] * 3
    dcp_ptrs = [_ptr(c) for c in dcps] if cps else [null] * 3
    lib, fn = _fn("render_level_bwd", "sanerf_final_level_bwd", 20, 8)
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(sh), _ptr(w0),
            _ptr(w1), _ptr(w2), _ptr(w3), *cp_ptrs, _ptr(g_f), _ptr(g_depth),
            _ptr(g_wsum), _ptr(g_w), _ptr(part), _ptr(out), *dcp_ptrs, ctas,
            N, T, freq_degree, rank, cp_res, H, kin, grid_bound,
            int(opaque_last), density_bias, _stream(dev))
    cuda_lib.check(lib, rc, "fused_final_level_bwd")
    fused_final_level_bwd.launches += 1
    d0, d1, d2, d3 = out.split(sizes)
    return [d0.view(H, kin)[:, :nin].contiguous(), d1.view(H, H),
            d2.view(H, H + kin)[:, :H + nin].contiguous(),
            d3.view(16, H)], dcps


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
