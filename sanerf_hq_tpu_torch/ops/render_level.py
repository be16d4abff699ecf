"""Render-level kernels: the proposal level with inverse-CDF resampling (K5)
and the final level with CP line features (K3), each a hand-written CUDA
kernel (`csrc/render_level.cu`) with a plain PyTorch twin beside it.

The wrappers keep the JAX names (`fused_prop_level_sample`,
`fused_final_level`).  A CPU tensor goes to the plain twin, and only a CPU
tensor; a CUDA tensor launches the kernel or raises.  Each wrapper counts
its kernel launches in its `launches` attribute.

Weights are in the port's [out, in] layout.  The twins repeat the kernels'
arithmetic: bf16 operands emulated as `x.to(torch.bfloat16).float()`, fp32
sums, the sequential transmittance product, and the resampling lookup
against the unnormalised running sum.  On the card they need
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default) to stay
fp32.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_lib
from .contraction import contract
from .fused_mlp import _reference_forward, _reference_forward_with_extra

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


def cp_features(xn, cps, cp_res: int):
    """Linear-interp CP line features, product over axes: xn [..., 3] in
    [-1, 1], cps three [cp_res, rank] bases -> [..., rank].  A two-tap
    gather; `f` reaches 1 at the top edge."""
    p = ((xn + 1.0) * 0.5).clamp(0.0, 1.0) * (cp_res - 1)
    i0 = torch.floor(p).clamp(0.0, cp_res - 2.0)
    f = p - i0
    i0 = i0.long()
    g = None
    for a in range(3):
        fa = f[..., a, None]
        la = cps[a][i0[..., a]] * (1.0 - fa) + cps[a][i0[..., a] + 1] * fa
        g = la if g is None else g * la
    return g


# ---------------------------------------------------------------------------
# K5: proposal level + inverse-CDF resampling (inference)
# ---------------------------------------------------------------------------

def prop_level_sample_ref(rays_o, rays_d, real_bins, s_bins, u,
                          ws: Sequence, freq_degree: int, grid_bound: float,
                          opaque_last: bool = True, density_bias: float = 0.0):
    """Plain twin of K5.  Returns the next level's s-space edges [N, Q]."""
    T = real_bins.shape[1] - 1
    _, delta, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    raw = _reference_forward(xn, ws, freq_degree, -1)[..., 0]
    sigma = _density(raw, density_bias)
    trans = torch.ones_like(sigma[:, 0])
    total = torch.zeros_like(trans)
    w = []
    for s in range(T):
        e = _segment_trans(delta, sigma, s, opaque_last)
        w.append((1.0 - e) * trans + 0.01)
        total = total + w[-1]
        trans = trans * e
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
    return s_g0 + t.clamp(0.0, 1.0) * (s_g1 - s_g0)


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


def _prop_lib():
    lib = cuda_lib.load("render_level")
    fn = lib.sanerf_prop_level_sample
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 6 + [_F, _I, _F, _P]
        fn.restype = _I
    return lib, fn


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
    dev = rays_o.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N, T, Q = rays_o.shape[0], real_bins.shape[1] - 1, u.shape[1]
    if len(ws) != 3:
        raise ValueError("the K5 kernel takes a 3-layer proposal MLP")
    H, nf = ws[0].shape[0], 3 + 6 * freq_degree
    if H % 16 or H > 256 or T < 1 or Q < 1:
        raise ValueError(f"unsupported K5 shape: hidden {H}, T {T}, Q {Q}")
    for name, x, shape in (("rays_o", rays_o, (N, 3)),
                           ("rays_d", rays_d, (N, 3)),
                           ("real_bins", real_bins, (N, T + 1)),
                           ("s_bins", s_bins, (N, T + 1)), ("u", u, (N, Q)),
                           ("ws[0]", ws[0], (H, nf)), ("ws[1]", ws[1], (H, H)),
                           ("ws[2]", ws[2], (1, H))):
        _check(name, x, shape, dev)
    kin = _round16(nf)
    w0 = _bf16_padded(ws[0], H, kin)
    w1 = ws[1].to(torch.bfloat16).contiguous()
    w2 = _bf16_padded(ws[2], 16, H)
    out = torch.empty((N, Q), dtype=torch.float32, device=dev)
    lib, fn = _prop_lib()
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(s_bins),
            _ptr(u), _ptr(w0), _ptr(w1), _ptr(w2), _ptr(out), N, T, Q,
            freq_degree, H, kin, grid_bound, int(opaque_last), density_bias,
            _stream(dev))
    cuda_lib.check(lib, rc, "fused_prop_level_sample")
    fused_prop_level_sample.launches += 1
    return out


fused_prop_level_sample.launches = 0


# ---------------------------------------------------------------------------
# K3: final level with CP line features
# ---------------------------------------------------------------------------

def final_level_ref(rays_o, rays_d, real_bins, sh, ws: Sequence,
                    freq_degree: int, skip_layer: int, grid_bound: float,
                    opaque_last: bool = True, density_bias: float = 0.0,
                    cps: Sequence = (), cp_res: int = 0):
    """Plain twin of K3.  Returns (f_image [N, 15+16], depth [N],
    weights_sum [N], weights [N, T])."""
    T = real_bins.shape[1] - 1
    t, delta, xn = _geometry(rays_o, rays_d, real_bins, grid_bound)
    if cps:
        extra = cp_features(xn, cps, cp_res)
        h = _reference_forward_with_extra(xn, extra, ws, freq_degree,
                                          skip_layer)
    else:
        h = _reference_forward(xn, ws, freq_degree, skip_layer)
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
    return f_image, depth, wsum, torch.stack(weights, dim=1)


def _final_lib():
    lib = cuda_lib.load("render_level")
    fn = lib.sanerf_final_level
    if fn.argtypes is None:
        fn.argtypes = [_P] * 15 + [_I] * 7 + [_F, _I, _F, _P]
        fn.restype = _I
    return lib, fn


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
    dev = rays_o.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N, T = rays_o.shape[0], real_bins.shape[1] - 1
    rank = cps[0].shape[1] if cps else 0
    if len(ws) != 4 or skip_layer != 2:
        raise ValueError("the K3 kernel takes a 4-layer trunk with its skip "
                         "at layer 2")
    H, nin = ws[0].shape[0], 3 + 6 * freq_degree + rank
    kin = _round16(nin)
    if H % 16 or H > 256 or kin > 128 or T < 1 or (cps and cp_res < 2):
        raise ValueError(f"unsupported K3 shape: hidden {H}, input {nin}, "
                         f"T {T}, cp_res {cp_res}")
    checks = [("rays_o", rays_o, (N, 3)), ("rays_d", rays_d, (N, 3)),
              ("real_bins", real_bins, (N, T + 1)),
              ("sh", sh, (N, SH_DIM)), ("ws[0]", ws[0], (H, nin)),
              ("ws[1]", ws[1], (H, H)), ("ws[2]", ws[2], (H, H + nin)),
              ("ws[3]", ws[3], (1 + GEO, H))]
    checks += [(f"cps[{a}]", c, (cp_res, rank)) for a, c in enumerate(cps)]
    for name, x, shape in checks:
        _check(name, x, shape, dev)
    w0 = _bf16_padded(ws[0], H, kin)
    w1 = ws[1].to(torch.bfloat16).contiguous()
    w2 = _bf16_padded(ws[2], H, H + kin)
    w3 = ws[3].to(torch.bfloat16).contiguous()
    f_image = torch.empty((N, GEO + SH_DIM), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    wsum = torch.empty((N,), dtype=torch.float32, device=dev)
    weights = torch.empty((N, T), dtype=torch.float32, device=dev)
    null = ctypes.c_void_p(0)
    cp_ptrs = [_ptr(c) for c in cps] if cps else [null] * 3
    lib, fn = _final_lib()
    rc = fn(_ptr(rays_o), _ptr(rays_d), _ptr(real_bins), _ptr(sh), _ptr(w0),
            _ptr(w1), _ptr(w2), _ptr(w3), *cp_ptrs, _ptr(f_image),
            _ptr(depth), _ptr(wsum), _ptr(weights), N, T, freq_degree, rank,
            cp_res, H, kin, grid_bound, int(opaque_last), density_bias,
            _stream(dev))
    cuda_lib.check(lib, rc, "fused_final_level")
    fused_final_level.launches += 1
    return f_image, depth, wsum, weights


fused_final_level.launches = 0
