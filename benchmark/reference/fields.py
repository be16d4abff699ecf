"""The two fields and their renderers, plain.

Parameters come as a dict of tensors under the program's parameter names
(the benchmark made them from the seed and gave the same values to both
sides); the widths come from the configuration file, and each parameter's
shape is checked against them.

  - MLP field: frequency encoding, a bias-free trunk (ReLU, the layer-0
    input concatenated back in at layer num_layers // 2) on [freq(x) | CP
    features], where the CP features are the product over the three axes
    of a linearly interpolated row of a [cp_res, rank] basis; density
    exp(clamp(raw + bias, -30, 15)); proposal MLPs of the same kind on
    freq(x) alone.  Positions are contracted and divided by grid_bound.
  - hash-grid field: the multiresolution hash encoding of Instant-NGP
    (tiled, hashed or dense levels, trilinear corners, zero outside the
    unit cube), bias-free ReLU MLPs, density trunc_exp; the object
    field's table m_grid and its leaky-ReLU mask MLP.
  - both: deferred colour, the view MLP on the composited [features |
    SH(d)] with a sigmoid; an opaque last sample.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .common import (composite_weights, contract, distortion_loss,
                     jittered_bins, mm, near_far_from_aabb, proposal_loss,
                     resample, resample_running_sum, sh4, spacing_fn,
                     spacing_fn_inv, strata, trunc_exp)

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _take(params, name, shape):
    p = params[name]
    if tuple(p.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(p.shape)}, the configuration "
                         f"says {tuple(shape)}")
    return p


def mlp_weights(params, prefix: str, dims: List[int],
                skip: Optional[int] = None, style: str = "layers"):
    """The [out, in] weights of a bias-free MLP through dims [in, ...,
    out]; `skip` widens that layer's input by dims[0]."""
    ws = []
    for l in range(len(dims) - 1):
        fin = dims[l] + (dims[0] if l == skip else 0)
        name = (f"{prefix}.w{l}" if style == "w"
                else f"{prefix}.layers.{l}.weight")
        ws.append(_take(params, name, (dims[l + 1], fin)))
    return ws


def run_mlp(h, ws, mode: str, act="relu", skip: Optional[int] = None):
    h_in = h
    for l, w in enumerate(ws):
        if l == skip:
            h = torch.cat([h, h_in], dim=-1)
        h = mm(h, w, mode)
        if l != len(ws) - 1:
            h = (torch.relu(h) if act == "relu"
                 else torch.nn.functional.leaky_relu(h, 0.01))
    return h


def freq_encode(x, degree: int):
    """[x | sin(2^k x) | cos(2^k x)], octaves k-major."""
    f = torch.cat([x * (2.0 ** k) for k in range(degree)], dim=-1)
    return torch.cat([x, torch.sin(f), torch.cos(f)], dim=-1)


def view_color(field, f_image):
    v = field.cfg["field"]["view_mlp"]
    ws = mlp_weights(field.p, "view_mlp",
                     [f_image.shape[-1]] + [v["hidden"]] * (v["layers"] - 1)
                     + [3])
    return torch.sigmoid(run_mlp(f_image, ws, field.modes["dense"]))


def _samples(rays_o, rays_d, real_bins, use_contract=True):
    t = (real_bins[:, 1:] + real_bins[:, :-1]) * 0.5
    delta = real_bins[:, 1:] - real_bins[:, :-1]
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    return t, delta, (contract(xyz) if use_contract else xyz)


def _ordered_weights(delta, sigma):
    """Weights with the transmittance as a running product, the last
    sample opaque."""
    e = torch.exp(-delta * sigma)
    e = torch.cat([e[:, :-1], torch.zeros_like(e[:, -1:])], dim=1)
    trans = torch.cumprod(torch.cat([torch.ones_like(e[:, :1]), e[:, :-1]],
                                    dim=1), dim=1)
    return (1.0 - e) * trans


# -- the MLP field ------------------------------------------------------------

class MLPField:
    """modes: {'products': the trunk's and proposal MLPs' operands,
    'dense': the view MLP's}."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 modes: Dict[str, str]):
        self.cfg, self.p, self.modes = cfg, params, modes
        self.mode = modes["products"]
        f = cfg["field"]
        self.bound = f["grid_bound"]
        self.db = f["density_bias"]
        in0 = 3 * (1 + 2 * f["freq_degree"]) + f["cp_rank"]
        dims = [in0] + [f["hidden"]] * (f["num_layers"] - 1) + [16]
        self.skip = f["num_layers"] // 2
        self.trunk = mlp_weights(params, "trunk", dims, self.skip, "w")
        self.cps = [_take(params, f"cp_{a}", (f["cp_res"], f["cp_rank"]))
                    for a in "xyz"]
        pin = 3 * (1 + 2 * f["prop_freq_degree"])
        pdims = [pin] + [f["prop_hidden"]] * (f["prop_layers"] - 1) + [1]
        self.props = [mlp_weights(params, f"prop_mlp_{k}", pdims, None, "w")
                      for k in range(2)]

    def _density(self, raw):
        return torch.exp((raw + self.db).clamp(-30.0, 15.0))

    def cp_features(self, xn):
        res = self.cfg["field"]["cp_res"]
        p = ((xn + 1.0) * 0.5).clamp(0.0, 1.0) * (res - 1)
        i0 = torch.floor(p).clamp(0.0, res - 2.0)
        f = p - i0
        i0 = i0.long()
        out = None
        for a in range(3):
            line = (self.cps[a][i0[..., a]] * (1.0 - f[..., a, None])
                    + self.cps[a][i0[..., a] + 1] * f[..., a, None])
            out = line if out is None else out * line
        return out

    def proposal(self, rays_o, rays_d, real_bins, level: int):
        """Per-sample weights [N, T] of a proposal level."""
        _, delta, xyz = _samples(rays_o, rays_d, real_bins)
        h = freq_encode(xyz / self.bound,
                        self.cfg["field"]["prop_freq_degree"])
        raw = run_mlp(h, self.props[level], self.mode)[..., 0]
        return _ordered_weights(delta, self._density(raw))

    def final(self, rays_o, rays_d, real_bins, need_geo: bool = False):
        """(f_image [N, 31], depth [N], weights_sum [N], weights [N, T],
        per-sample features or None)."""
        t, delta, xyz = _samples(rays_o, rays_d, real_bins)
        xn = xyz / self.bound
        h = torch.cat([freq_encode(xn, self.cfg["field"]["freq_degree"]),
                       self.cp_features(xn)], dim=-1)
        out = run_mlp(h, self.trunk, self.mode, skip=self.skip)
        w = _ordered_weights(delta, self._density(out[..., 0]))
        feat = out[..., 1:]
        sh = sh4(rays_d)
        wsum = w.sum(-1)
        f_image = torch.cat([(w[..., None] * feat).sum(1),
                             wsum[:, None] * sh], dim=-1)
        return f_image, (w * t).sum(-1), wsum, w, (feat if need_geo else None)


def render_mlp(field: MLPField, rays_o, rays_d, cfg: dict, draws=None,
               losses: bool = False, update_proposal: bool = True):
    """Proposal levels then the final level, resampling each next level's
    edges from the floored weights; `draws` jitters (training).  Returns
    {image, depth, weights_sum} and, with losses, proposal_loss and
    distort_loss."""
    steps = cfg["field"]["num_steps"]
    N, dev = rays_o.shape[0], rays_o.device
    near, far = near_far_from_aabb(rays_o, rays_d, cfg["bound"],
                                   cfg["min_near"])
    sn, sf = spacing_fn(near), spacing_fn(far)
    bins = jittered_bins(N, steps[0], dev, draws)
    all_bins, all_w = [], []
    for level in range(len(steps) - 1):
        real = spacing_fn_inv(sn * (1.0 - bins) + sf * bins)
        u = strata(N, steps[level + 1] + 1, dev, draws)
        w = field.proposal(rays_o, rays_d, real, level)
        all_bins.append(bins)
        all_w.append(w if update_proposal else w.detach())
        bins = resample_running_sum(bins, w, u)
    real = spacing_fn_inv(sn * (1.0 - bins) + sf * bins)
    f_image, depth, wsum, w, _ = field.final(rays_o, rays_d, real)
    image = view_color(field, f_image)
    out = {"image": image + (1.0 - wsum)[..., None], "depth": depth,
           "weights_sum": wsum}
    if losses:
        all_bins.append(bins)
        all_w.append(w)
        out["proposal_loss"] = (proposal_loss(all_bins, all_w)
                                if update_proposal
                                else torch.zeros((), device=dev))
        out["distort_loss"] = distortion_loss(bins, w)
    return out


# -- the hash-grid field ------------------------------------------------------

def grid_levels(spec: dict):
    """Per level (resolution, offset, size, use_hash, dense strides), as
    the reference encoder lays out its table."""
    L, base = spec["num_levels"], spec["base_resolution"]
    scale = float(np.exp2(np.log2(spec["desired_resolution"] / base)
                          / (L - 1)))
    out, offset = [], 0
    for lvl in range(L):
        res = int(np.ceil(base * scale ** lvl))
        size = min(2 ** spec["log2_hashmap_size"], res ** 3)
        size = int(np.ceil(size / 8) * 8)
        strides, stride = [], 1
        for _ in range(3):
            if stride > size:
                break
            strides.append(stride)
            stride *= res
        strides += [0] * (3 - len(strides))
        out.append((res, offset, size, stride > size, strides))
        offset += size
    return out


def grid_rows(spec: dict) -> int:
    lv = grid_levels(spec)
    return lv[-1][1] + lv[-1][2]


def hash_encode(table, x, spec: dict, bound: float):
    """World coordinates in [-bound, bound] -> [..., L * C]: for each level
    the trilinear blend of its 8 corner rows; zero outside the cube."""
    C = spec["level_dim"]
    prefix = x.shape[:-1]
    u = ((x.reshape(-1, 3).float() + bound) / (2.0 * bound))
    oob = ((u < 0.0) | (u > 1.0)).any(dim=-1, keepdim=True)
    u = u.clamp(0.0, 1.0)
    feats = []
    for res, offset, size, use_hash, strides in grid_levels(spec):
        pos = torch.minimum((u * res - 0.5).clamp_min(0.0),
                            torch.tensor(float(res - 1), device=u.device))
        lo = torch.floor(pos)
        frac = pos - lo
        lo = lo.long()
        hi = torch.clamp_max(lo + 1, res - 1)
        acc = 0.0
        for corner in range(8):
            c = [hi[:, d] if (corner >> d) & 1 else lo[:, d] for d in range(3)]
            w = 1.0
            for d in range(3):
                w = w * (frac[:, d] if (corner >> d) & 1 else 1.0 - frac[:, d])
            if use_hash:
                idx = ((c[0] * _PRIMES[0]) & _U32) ^ ((c[1] * _PRIMES[1])
                                                       & _U32) \
                    ^ ((c[2] * _PRIMES[2]) & _U32)
            else:
                idx = (c[0] * strides[0] + c[1] * strides[1]
                       + c[2] * strides[2]) & _U32
            acc = acc + w[:, None] * table[idx % size + offset]
        feats.append(acc)
    out = torch.cat(feats, dim=-1).masked_fill(oob, 0.0)
    return out.reshape(*prefix, spec["num_levels"] * C)


class HashField:
    """modes: {'dense': every MLP's operands}."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 modes: Dict[str, str]):
        self.cfg, self.p, self.modes = cfg, params, modes
        self.mode = modes["dense"]
        f = cfg["field"]
        self.bound = f["grid_bound"]

        def table(name, spec):
            return _take(params, name, (grid_rows(spec), spec["level_dim"]))

        def width(spec):
            return spec["num_levels"] * spec["level_dim"]

        self.main = f["main_grid"]
        self.grid = table("grid", self.main)
        g = f["grid_mlp"]
        self.grid_mlp = mlp_weights(params, "grid_mlp", [width(self.main)]
                                    + [g["hidden"]] * (g["layers"] - 1)
                                    + [16])
        pm = f["prop_mlp"]
        self.prop_specs = f["prop_grids"]
        self.prop_tables = [table(f"prop_grid_{k}", s)
                            for k, s in enumerate(self.prop_specs)]
        self.prop_mlps = [mlp_weights(params, f"prop_mlp_{k}", [width(s)]
                                      + [pm["hidden"]] * (pm["layers"] - 1)
                                      + [1])
                          for k, s in enumerate(self.prop_specs)]
        self.mask_spec = f.get("mask_grid")
        if self.mask_spec is not None and "m_grid" in params:
            self.m_grid = table("m_grid", self.mask_spec)
            mm_ = f["mask_mlp"]
            self.mask_mlp = mlp_weights(
                params, "mask_mlp", [width(self.mask_spec) + 15]
                + [mm_["hidden"]] * (mm_["layers"] - 1) + [f["n_inst"]])

    def proposal_sigma(self, xyz, level: int):
        h = hash_encode(self.prop_tables[level], xyz, self.prop_specs[level],
                        self.bound)
        return trunc_exp(run_mlp(h, self.prop_mlps[level], self.mode)[..., 0])

    def color(self, xyz, dirs):
        h = hash_encode(self.grid, xyz, self.main, self.bound)
        f = run_mlp(h, self.grid_mlp, self.mode)
        return trunc_exp(f[..., 0]), f[..., 1:]

    def mask_logits(self, xyz, geo):
        m = hash_encode(self.m_grid, xyz, self.mask_spec, self.bound)
        return run_mlp(torch.cat([m, geo], dim=-1), self.mask_mlp, self.mode,
                       act="leaky")


def render_hash(field: HashField, rays_o, rays_d, cfg: dict, draws=None,
                losses: bool = False, update_proposal: bool = True,
                mask: bool = False):
    """Composable proposal sampling on the hash-grid field: each level's
    densities composited into weights, the next level's edges resampled
    from them.  Returns {image, depth, weights_sum} (+ losses, + the
    object field's logits with mask)."""
    steps = cfg["field"]["num_steps"]
    N, dev = rays_o.shape[0], rays_o.device
    near, far = near_far_from_aabb(rays_o, rays_d, cfg["bound"],
                                   cfg["min_near"])
    sn, sf = spacing_fn(near), spacing_fn(far)
    bins = jittered_bins(N, steps[0], dev, draws)
    all_bins, all_w = [], []
    for level, T in enumerate(steps):
        if level > 0:
            bins = resample(bins, w, T + 1, draws)
        real = spacing_fn_inv(sn * (1.0 - bins) + sf * bins)
        t, delta, xyz = _samples(rays_o, rays_d, real)
        if level < len(steps) - 1:
            sigma = field.proposal_sigma(xyz, level)
            if not update_proposal:
                sigma = sigma.detach()
        else:
            d = rays_d[:, None, :].expand(xyz.shape)
            sigma, geo = field.color(xyz, d)
        w = composite_weights(delta, sigma)
        all_bins.append(bins)
        all_w.append(w)
    sh = sh4(rays_d)
    f_image = torch.cat([(w[..., None] * geo).sum(1),
                         w.sum(-1)[:, None] * sh], dim=-1)
    wsum = w.sum(-1)
    image = view_color(field, f_image)
    out = {"image": image + (1.0 - wsum)[..., None], "depth": (w * t).sum(-1),
           "weights_sum": wsum}
    if losses:
        out["proposal_loss"] = (proposal_loss(all_bins, all_w)
                                if update_proposal
                                else torch.zeros((), device=dev))
        out["distort_loss"] = distortion_loss(bins, w)
    if mask:
        logits = field.mask_logits(xyz, geo.detach())
        out["instance_mask_logits"] = (w.detach()[..., None] * logits).sum(1)
    return out
