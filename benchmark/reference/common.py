"""Shared pieces of the reference: operand precision, rays and sampling
warps, contraction, spherical harmonics, compositing, the renderer's
losses, inverse-CDF resampling and Adam.  Plain PyTorch throughout."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _straight_through(x, r):
    """r in the forward, the identity's gradient in the backward."""
    return x + (r - x).detach()


def round_to(x, mode: str):
    """The value an operand of precision `mode` holds: fp32 as it is; tf32
    with its mantissa rounded to 10 bits (to nearest, ties away); bf16;
    fp8 e4m3 after a per-tensor scale that maps the largest magnitude to
    448, as an fp8 product takes its operands."""
    if mode == "fp32":
        return x
    x = x.float()
    if mode == "tf32":
        i = x.detach().contiguous().view(torch.int32)
        r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    elif mode == "bf16":
        r = x.detach().to(torch.bfloat16).float()
    elif mode == "fp8":
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    else:
        raise ValueError(f"unknown precision {mode!r}")
    return _straight_through(x, r)


def mm(x, w, mode: str):
    """x [..., k] times w [n, k] transposed, each operand at `mode`, sums
    in fp32 (the caller keeps TF32 off)."""
    return round_to(x, mode) @ round_to(w, mode).t()


# -- rays ---------------------------------------------------------------------

def rays_from_pixels(poses, intrinsics, x, y):
    """poses [N, 4, 4] (or [4, 4]) cam2world, OpenGL axes; intrinsics [4]
    or [N, 4]; x, y pixel-centre coordinates [N].  Unnormalised
    directions, so depth is z-distance."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    dirs = torch.stack([(x - cx) / fx, -(y - cy) / fy,
                        -torch.ones_like(x)], dim=-1)
    if poses.dim() == 2:
        return poses[:3, 3].expand(dirs.shape), dirs @ poses[:3, :3].T
    return poses[:, :3, 3], torch.einsum("nij,nj->ni", poses[:, :3, :3],
                                         dirs)


def full_frame_rays(pose, intrinsics, H: int, W: int):
    """All H*W rays of a view, row-major, at pixel centres."""
    dev = pose.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    return rays_from_pixels(pose, intrinsics, xx.reshape(-1) + 0.5,
                            yy.reshape(-1) + 0.5)


def near_far_from_aabb(rays_o, rays_d, bound: float, min_near: float):
    """Slab test against the cube [-bound, bound]^3; a miss gives 1e9."""
    lo = torch.full((3,), -bound, device=rays_o.device)
    tmin = (lo - rays_o) / (rays_d + 1e-15)
    tmax = (-lo - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(tmin, tmax).amax(dim=-1, keepdim=True)
    far = torch.maximum(tmin, tmax).amin(dim=-1, keepdim=True)
    miss = far < near
    near = torch.where(miss, torch.full_like(near, 1e9), near)
    far = torch.where(miss, torch.full_like(far, 1e9), far)
    return near.clamp_min(min_near), far


def spacing_fn(x):
    return torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * x.clamp_min(1e-8)))


def spacing_fn_inv(s):
    return torch.where(s < 0.5, 2.0 * s, 1.0 / (2.0 - 2.0 * s).clamp_min(1e-8))


def contract(x):
    """Inf-norm scene contraction into [-2, 2]^3."""
    ax = x.abs()
    mag = ax.amax(dim=-1, keepdim=True)
    inv = 1.0 / mag.clamp_min(1e-38)
    scale = torch.where(ax == mag, (2.0 - inv) * inv, inv)
    return torch.where(mag < 1.0, x, x * scale)


def jittered_bins(n: int, t: int, device, draws) -> torch.Tensor:
    """Level 0's s-space edges [n, t + 1], jittered by a draw."""
    bins = torch.linspace(0.0, 1.0, t + 1, device=device).expand(n, t + 1)
    if draws is None:
        return bins.contiguous()
    return (bins + (draws.rand((n, t + 1)) - 0.5) / t).clamp(0, 1)


def strata(n: int, q: int, device, draws) -> torch.Tensor:
    """[n, q] midpoints of q strata, jittered by +-0.5/q with a draw."""
    u = torch.linspace(0.5 / q, 1.0 - 0.5 / q, q, device=device).expand(n, q)
    if draws is None:
        return u
    return u + (draws.rand((n, q)) - 0.5) / q


# -- encodings and activations ------------------------------------------------

def sh4(d):
    """Real spherical harmonics of degree 4 (16 values) of directions d."""
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-8)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=-1)


class _TruncExp(torch.autograd.Function):
    """exp(x) whose gradient takes exp of x clamped to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x.float())


# -- compositing and losses ---------------------------------------------------

def composite_weights(deltas, sigmas, opaque_last: bool = True):
    """Alpha-compositing weights [N, T]; the last sample opaque."""
    ds = deltas * sigmas
    if opaque_last:
        ds = torch.cat([ds[..., :-1], torch.full_like(ds[..., -1:],
                                                      torch.inf)], dim=-1)
    alphas = 1.0 - torch.exp(-ds)
    accum = torch.cumsum(ds[..., :-1], dim=-1)
    accum = torch.cat([torch.zeros_like(accum[..., :1]), accum], dim=-1)
    return torch.nan_to_num(alphas * torch.exp(-accum), nan=0.0)


def distortion_loss(bins, weights):
    """mip-NeRF 360's distortion loss over s-space edges, mean over rays."""
    itv = bins[..., 1:] - bins[..., :-1]
    mid = bins[..., :-1] + itv / 2.0
    uni = (1.0 / 3.0) * (itv * weights ** 2).sum(dim=-1)
    wm = weights * mid
    bi = 2.0 * (wm[..., 1:] * torch.cumsum(weights, -1)[..., :-1]
                - weights[..., 1:] * torch.cumsum(wm, -1)[..., :-1]).sum(-1)
    return (uni + bi).mean()


def _count_le(sorted_rows, queries):
    return (sorted_rows[:, None, :] <= queries[:, :, None]).sum(dim=-1)


def interlevel_loss(t0, w0, t1, w1):
    """A proposal histogram (t1, w1) against the final one (t0, w0): the
    shortfall of the proposal mass overlapping each final interval."""
    T1 = w1.shape[-1]
    iota = torch.arange(T1, device=w1.device)
    lo = (_count_le(t1[..., :-1], t0[..., :-1]) - 1).clamp(0, T1 - 1)
    hi = _count_le(t1[..., 1:], t0[..., 1:]).clamp(0, T1 - 1)
    band = (lo[..., None] <= iota) & (iota <= hi[..., None])
    w = torch.where(band, w1[:, None, :], 0.0).sum(dim=-1)
    return torch.clamp_min(w0 - w, 0.0) ** 2 / (w0 + 1e-8)


def proposal_loss(all_bins, all_weights):
    ref_b, ref_w = all_bins[-1].detach(), all_weights[-1].detach()
    return sum(interlevel_loss(ref_b, ref_w, b, w).mean()
               for b, w in zip(all_bins[:-1], all_weights[:-1]))


def lookup(cdf, bins, u):
    """Inverse-CDF lookup: per query, the edges below and above it on the
    CDF, and the linear interpolation between them."""
    le = cdf[:, None, :] <= u[:, :, None]
    neg = torch.tensor(-1e38, device=cdf.device)
    pos = torch.tensor(1e38, device=cdf.device)
    c0 = torch.where(le, cdf[:, None, :], neg).amax(dim=-1)
    b0 = torch.where(le, bins[:, None, :], neg).amax(dim=-1)
    c1 = torch.minimum(torch.where(le, pos, cdf[:, None, :]).amin(dim=-1),
                       cdf[:, -1:])
    b1 = torch.minimum(torch.where(le, pos, bins[:, None, :]).amin(dim=-1),
                       bins[:, -1:])
    den = c1 - c0
    t = torch.where(den > 0, (u - c0) / torch.where(den > 0, den, 1.0), 0.0)
    return b0 + torch.nan_to_num(t).clamp(0.0, 1.0) * (b1 - b0)


def resample(bins, weights, q: int, draws):
    """q new edges from a weight histogram floored by 0.01 (normalised
    CDF), queries at jittered strata."""
    w = weights.detach() + 0.01
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1).clamp_max(1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = strata(w.shape[0], q, w.device, draws)
    return lookup(cdf, bins.detach(), u)


def resample_running_sum(bins, w_raw, u):
    """The same resampling written against the unnormalised running sum
    of the floored weights (the scaled queries u * total)."""
    w = w_raw.detach() + 0.01
    total = w.sum(-1)
    c = torch.minimum(torch.cumsum(w, -1), total[:, None])
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=-1)
    return lookup(c, bins.detach(), u * total[:, None])


# -- the optimizer ------------------------------------------------------------

class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-15) over named parameters, each with
    a learning-rate scale; lr(t) = lr * 0.1 ** min(t / iters, 1) at update
    t, counted from the step t the first update is made at (0 unless
    given).  A parameter without a gradient is not updated."""

    B1, B2, EPS = 0.9, 0.999, 1e-15

    def __init__(self, params: Dict[str, torch.Tensor],
                 scales: Dict[str, float], lr: float, iters: int,
                 t: int = 0):
        self.params, self.scales = params, scales
        self.lr, self.iters, self.t = lr, iters, t
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = {n: 0 for n in params}

    def load(self, state: Dict[str, tuple]):
        """Take over (first moment, second moment, updates made) by
        name."""
        for n, (m, v, k) in state.items():
            self.m[n], self.v[n], self.count[n] = m.clone(), v.clone(), k

    @torch.no_grad()
    def step(self):
        lr = self.lr * 0.1 ** min(self.t / self.iters, 1.0)
        for n, p in self.params.items():
            g = p.grad
            if g is None:
                continue
            self.count[n] += 1
            k = self.count[n]
            self.m[n].lerp_(g, 1 - self.B1)
            self.v[n].mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            denom = (self.v[n].sqrt() / (1 - self.B2 ** k) ** 0.5).add_(
                self.EPS)
            p.addcdiv_(self.m[n], denom,
                       value=-lr * self.scales[n] / (1 - self.B1 ** k))
            p.grad = None
        self.t += 1


class Draws:
    """The random numbers of a step, drawn in the program's order from a
    generator set to the program's state: the reference reads the same
    batch, jitter and anchors as the program did."""

    def __init__(self, state: torch.Tensor, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device)
        self.gen.set_state(state)

    def rand(self, shape: Tuple[int, ...], dtype=torch.float32):
        return torch.rand(shape, generator=self.gen, device=self.device,
                          dtype=dtype)

    def randint(self, high: int, shape: Tuple[int, ...]):
        return torch.randint(0, high, shape, generator=self.gen,
                             device=self.device)

    def exponential(self, shape: Tuple[int, ...]):
        return torch.empty(shape, device=self.device).exponential_(
            generator=self.gen)

    def multinomial(self, probs, n: int):
        return torch.multinomial(probs, n, generator=self.gen)
