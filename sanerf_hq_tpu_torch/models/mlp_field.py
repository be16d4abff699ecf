"""Flagship field: frequency-encoded MLP radiance field with CP line
features (stage 1 only).

Deferred colour: per-sample features are composited, then the small view
MLP runs per ray.  Proposal densities come from small freq-encoded MLPs.
The renderer drives the level kernels through `fused_prop_next_bins` (K5)
and `fused_final_render` (K3) for inference, and through
`fused_prop_weights_train_sample` (K1, backward K2) and
`fused_final_render_train` (K3, backward K4) for training; `density` /
`forward_color` are the composable route.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.fused_mlp import _reference_forward, _reference_forward_with_extra
from ..ops.render_level import (cp_features, final_level_train,
                                fused_final_level, fused_prop_level_sample,
                                prop_level_train_sample)
from ..ops.sh import sh_encode
from ..ops.trunc_exp import safe_trunc_exp
from .mlp import MLP, uniform_fan_in_

GEOM_FEAT_DIM = 15
SH_DEGREE = 4
SH_DIM = SH_DEGREE * SH_DEGREE


class FreqMLP(nn.Module):
    """Frequency-encode -> bias-free trunk (bf16 compute emulated, fp32
    parameters and outputs).  Weights w0..w{L-1} are [out, in]; layer 0
    reads [freq(x) | extra]; the skip layer reads [act | layer-0 input]."""

    def __init__(self, dim_out: int, dim_hidden: int = 256,
                 num_layers: int = 4, freq_degree: int = 10,
                 skip_layer: int = -1, extra_dim: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freq_degree = freq_degree
        self.skip_layer = skip_layer
        self.num_layers = num_layers
        in_dim = 3 * (1 + 2 * freq_degree) + extra_dim  # [x | sin | cos | extra]
        fin = in_dim
        for l in range(num_layers):
            if l == skip_layer:
                fin += in_dim
            fout = dim_out if l == num_layers - 1 else dim_hidden
            w = nn.Parameter(torch.empty(fout, fin, device=device))
            uniform_fan_in_(w, fin, generator)
            self.register_parameter(f"w{l}", w)
            fin = fout

    @property
    def weights(self):
        return [getattr(self, f"w{l}") for l in range(self.num_layers)]

    def forward(self, x, extra=None):
        if extra is not None:
            return _reference_forward_with_extra(
                x, extra, self.weights, self.freq_degree, self.skip_layer)
        return _reference_forward(x, self.weights, self.freq_degree,
                                  self.skip_layer)


class MLPField(nn.Module):
    def __init__(self, grid_bound: float = 2.0, hidden: int = 256,
                 num_layers: int = 4, freq_degree: int = 10,
                 prop_hidden: int = 64, prop_layers: int = 3,
                 prop_freq_degree: int = 6, density_bias: float = 0.0,
                 cp_rank: int = 0, cp_res: int = 256, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.grid_bound = grid_bound
        self.num_layers = num_layers
        self.freq_degree = freq_degree
        self.prop_freq_degree = prop_freq_degree
        self.density_bias = density_bias
        self.cp_rank = cp_rank
        self.cp_res = cp_res
        self.trunk = FreqMLP(1 + GEOM_FEAT_DIM, hidden, num_layers,
                             freq_degree, skip_layer=num_layers // 2,
                             extra_dim=cp_rank, device=device, generator=g)
        if cp_rank > 0:
            for a in "xyz":
                basis = torch.randn((cp_res, cp_rank), generator=g) * 0.3
                self.register_parameter(
                    f"cp_{a}", nn.Parameter(basis.to(device)))
        self.view_mlp = MLP(GEOM_FEAT_DIM + SH_DIM, 3, 32, 3, device=device,
                            generator=g)
        self.prop_mlp_0 = FreqMLP(1, prop_hidden, prop_layers,
                                  prop_freq_degree, device=device, generator=g)
        self.prop_mlp_1 = FreqMLP(1, prop_hidden, prop_layers,
                                  prop_freq_degree, device=device, generator=g)

    @property
    def cp_basis(self):
        return [self.cp_x, self.cp_y, self.cp_z] if self.cp_rank > 0 else []

    def _norm(self, x):
        # contracted coords in [-grid_bound, grid_bound] -> [-1, 1]
        return x / self.grid_bound

    def _density_act(self, raw):
        return safe_trunc_exp(raw + self.density_bias)

    def cp_features(self, xn):
        """xn: [..., 3] in [-1, 1] -> [..., cp_rank] line features."""
        return cp_features(xn, self.cp_basis, self.cp_res)

    def common_forward(self, x):
        xn = self._norm(x)
        extra = self.cp_features(xn) if self.cp_rank > 0 else None
        f = self.trunk(xn, extra=extra)
        return self._density_act(f[..., 0]), f[..., 1:], f

    def density(self, x, proposal: int = -1):
        if proposal in (0, 1):
            mlp = self.prop_mlp_0 if proposal == 0 else self.prop_mlp_1
            return self._density_act(mlp(self._norm(x))[..., 0])
        sigma, _, _ = self.common_forward(x)
        return sigma

    def forward_color(self, x, d):
        sigma, feat, raw = self.common_forward(x)
        color = torch.cat([feat, sh_encode(d, SH_DEGREE)], dim=-1)
        return sigma, feat, color, raw

    def apply_view_mlp(self, f_image):
        return self.view_mlp(f_image)

    # level kernels (ops/render_level.py)
    supports_fused_final = True

    def fused_prop_next_bins(self, rays_o, rays_d, real_bins, s_bins, u,
                             proposal: int, opaque_last: bool = True):
        """Proposal level + inverse-CDF resampling in one kernel: the NEXT
        level's s-space bin edges [N, Q]."""
        mlp = self.prop_mlp_0 if proposal == 0 else self.prop_mlp_1
        return fused_prop_level_sample(
            rays_o, rays_d, real_bins, s_bins, u, mlp.weights,
            self.prop_freq_degree, self.grid_bound, opaque_last=opaque_last,
            density_bias=self.density_bias)

    def _final_args(self, rays_d):
        d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return sh_encode(d, SH_DEGREE), self.trunk.weights

    def fused_final_render(self, rays_o, rays_d, real_bins,
                           opaque_last: bool = True):
        """Final level in one kernel.  Returns (f_image [N, 31], depth [N],
        weights_sum [N])."""
        sh, ws = self._final_args(rays_d)
        f_image, depth, wsum, _ = fused_final_level(
            rays_o, rays_d, real_bins, sh, ws, self.freq_degree,
            skip_layer=self.num_layers // 2, grid_bound=self.grid_bound,
            opaque_last=opaque_last, density_bias=self.density_bias,
            cps=self.cp_basis, cp_res=self.cp_res)
        return f_image, depth, wsum

    def fused_prop_weights_train_sample(self, rays_o, rays_d, real_bins,
                                        s_bins, u, proposal: int,
                                        opaque_last: bool = True):
        """Training twin of fused_prop_next_bins: (weights [N, T] for the
        interlevel loss, next s-space edges [N, Q], non-differentiable);
        grads reach the proposal weights through K2."""
        mlp = self.prop_mlp_0 if proposal == 0 else self.prop_mlp_1
        return prop_level_train_sample(
            rays_o, rays_d, real_bins, s_bins, u, mlp.weights,
            self.prop_freq_degree, self.grid_bound, opaque_last=opaque_last,
            density_bias=self.density_bias)

    def fused_final_render_train(self, rays_o, rays_d, real_bins,
                                 opaque_last: bool = True):
        """Differentiable final level (K3, backward K4).  Returns
        (f_image [N, 31], depth [N], weights_sum [N], weights [N, T])."""
        sh, ws = self._final_args(rays_d)
        return final_level_train(
            rays_o, rays_d, real_bins, sh, ws, self.freq_degree,
            skip_layer=self.num_layers // 2, grid_bound=self.grid_bound,
            opaque_last=opaque_last, density_bias=self.density_bias,
            cps=self.cp_basis, cp_res=self.cp_res)


def make_field(field_type: str = "hashgrid", device=None, seed: int = 0,
               **kw):
    """Factory: 'mlp' (flagship).  The hash-grid fields are not ported yet."""
    if field_type in ("hashgrid", "hashgrid_packed"):
        raise NotImplementedError(
            f"field_type '{field_type}' is not ported yet (ROADMAP.md, "
            "queue 1, M12); use --field_type mlp")
    if field_type == "mlp":
        allowed = {"grid_bound", "hidden", "num_layers", "freq_degree",
                   "prop_hidden", "prop_layers", "prop_freq_degree",
                   "density_bias", "cp_rank", "cp_res"}
        return MLPField(**{k: v for k, v in kw.items() if k in allowed},
                        device=device, seed=seed)
    raise ValueError(f"unknown field_type {field_type}")
