"""Flagship field: frequency-encoded MLP radiance field with CP line
features, and the stage-3 object field (mask branch) on top of it.

Deferred colour: per-sample features are composited, then the small view
MLP runs per ray.  Proposal densities come from small freq-encoded MLPs.
The renderer drives the level kernels through `fused_prop_next_bins` (K5)
and `fused_final_render` (K3) for inference, through
`fused_prop_weights_train_sample` (K1, backward K2) and
`fused_final_render_train` (K3, backward K4) for training, and through
`fused_prop_next_bins(frozen=True)` (K5) and `fused_final_render_frozen`
(K6) for the mask branch over a frozen backbone.  `density` /
`forward_color` are the composable route: the proposal MLPs and, without
CP features, the trunk run K8 (`FreqMLP`, ops/fused_mlp.py); the trunk
with CP features stays plain, as in JAX.  `fused_prop_weights` (K7) and
`fused_prop_weights_train` (K7, backward K2) return a proposal level's
weights; no route of the renderer calls them, as in JAX.

The mask branch (`with_mask`): with feat_rep 'cp' a rank-`feat_rank` CP
feature volume `cp_m_{x,y,z}` [feat_res, feat_rank] with a projection
`cp_m_proj` [feat_rank, C]; with feat_rep 'hashgrid' the hash table
`m_grid` of the hash-grid field's object field (never packed here).  C is
the width of that table's spec: `feat_spec` or feature_grid_spec() (128)
for the default mask MLP, lightweight_mask_grid_spec() (32) for the
lightweight one.  `mask_features` reads it, and the mask MLP on
[features | trunk features] (default, a bias-free SkipConnMLP 256 x 3) or
[features | colour] (lightweight, a bias-free MLP 64 x 3) gives n_inst
logits.  Over a frozen backbone the level kernels (K5, K6) still render
the backbone; only the mask features come from the CP volume or the
table.

The SAM feature branch (`with_sam`, stage 2's distill container): with
feat_rep 'cp' the CP volume `cp_s_{x,y,z}` [feat_res, feat_rank] with
`cp_s_proj` [feat_rank, C], with 'hashgrid' the table `s_grid`; C is the
width of `feat_spec` or feature_grid_spec() (128).  `sam_features` reads
it; `samvit_mlp` (a SkipConnMLP with biases, 256 x 5, the input
concatenated back in at layer 2) and `samvit_norm` (LayerNorm, eps 1e-5)
map the renderer's composited [features | trunk features | image | depth]
(with `sam_use_view_direction`, [features | f_image | image | depth]) to
SAM's 256 channels.  The MLP's input width is that composition's: C + 15
+ 4, or C + 31 + 4 with the view direction (the reference builds it at
C + 35 either way, which crashes without the view direction).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.fused_mlp import _reference_forward_with_extra, fused_freq_mlp
from ..ops.hashgrid import HashGridSpec, hash_encode, init_hash_table
from ..ops.render_level import (cp_features, final_level_train,
                                fused_final_level, fused_final_level_frozen,
                                fused_prop_level, fused_prop_level_sample,
                                prop_level_train, prop_level_train_sample)
from ..ops.sh import sh_encode
from ..ops.trunc_exp import safe_trunc_exp
from .fields import (SANeRFField, feature_grid_spec, make_samvit_head,
                     mask_grid_spec)
from .mlp import MLP, SkipConnMLP, uniform_fan_in_

GEOM_FEAT_DIM = 15
SH_DEGREE = 4
SH_DIM = SH_DEGREE * SH_DEGREE


class FreqMLP(nn.Module):
    """Frequency-encode -> bias-free trunk (bf16 compute, fp32 parameters
    and outputs).  Weights w0..w{L-1} are [out, in]; layer 0 reads
    [freq(x) | extra]; the skip layer reads [act | layer-0 input].  Without
    extra features it is K8 (`fused_freq_mlp`); with them the plain
    version, as the JAX FreqMLP takes its reference there."""

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
        return fused_freq_mlp(x, self.weights, self.freq_degree,
                              self.skip_layer)


class MLPField(nn.Module):
    def __init__(self, grid_bound: float = 2.0, hidden: int = 256,
                 num_layers: int = 4, freq_degree: int = 10,
                 prop_hidden: int = 64, prop_layers: int = 3,
                 prop_freq_degree: int = 6, density_bias: float = 0.0,
                 cp_rank: int = 0, cp_res: int = 256, with_mask: bool = False,
                 n_inst: int = 2, mask_mlp_type: str = "default",
                 feat_rep: str = "cp", feat_rank: int = 128,
                 feat_res: int = 256,
                 feat_spec: Optional[HashGridSpec] = None,
                 with_sam: bool = False,
                 sam_use_view_direction: bool = False, device=None,
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
        self.with_mask = with_mask
        self.mask_mlp_type = mask_mlp_type
        self.n_inst = n_inst
        self.feat_res = feat_res
        self.feat_rank = feat_rank
        self.feat_rep = feat_rep
        # the feature containers are drawn last, the mask branch's first:
        # the backbone's init does not depend on them
        if with_mask:
            self.m_spec = mask_grid_spec(mask_mlp_type, feat_spec)
            channels = self.m_spec.output_dim
            self._make_container("m", self.m_spec, device, g)
            if mask_mlp_type == "default":
                self.mask_mlp = SkipConnMLP(channels + GEOM_FEAT_DIM, n_inst,
                                            256, 3, use_bias=False,
                                            device=device, generator=g)
            else:
                self.mask_mlp = MLP(channels + GEOM_FEAT_DIM + SH_DIM, n_inst,
                                    64, 3, device=device, generator=g)
        self.with_sam = with_sam
        self.sam_use_view_direction = sam_use_view_direction
        if with_sam:
            self.s_spec = feat_spec or feature_grid_spec()
            self._make_container("s", self.s_spec, device, g)
            self.samvit_mlp, self.samvit_norm = make_samvit_head(
                self.s_spec.output_dim, sam_use_view_direction, device, g)

    def _make_container(self, tag: str, spec: HashGridSpec, device, g):
        """The feature volume of a branch (tag 'm' or 's'): CP bases
        cp_{tag}_{x,y,z} [feat_res, feat_rank] ~ N(0, 0.3^2) and the
        projection cp_{tag}_proj [feat_rank, C] ~ N(0, 0.1^2), or the hash
        table {tag}_grid at spec."""
        if self.feat_rep == "cp":
            for a in "xyz":
                basis = torch.randn((self.feat_res, self.feat_rank),
                                    generator=g) * 0.3
                self.register_parameter(f"cp_{tag}_{a}",
                                        nn.Parameter(basis.to(device)))
            proj = torch.randn((self.feat_rank, spec.output_dim),
                               generator=g) * 0.1
            self.register_parameter(f"cp_{tag}_proj",
                                    nn.Parameter(proj.to(device)))
        else:
            self.register_parameter(
                f"{tag}_grid", nn.Parameter(init_hash_table(g, spec, device)))

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

    def _container_features(self, x, tag: str, spec: HashGridSpec):
        """Contracted world coords [..., 3] -> [..., C] features of a
        branch's volume: the {tag}_grid encoding (feat_rep 'hashgrid'), or
        the CP features: per axis a two-hot linear-interpolation row over
        feat_res times the basis cp_{tag}_{axis}, the product over axes,
        then the projection.  Written as the JAX field writes it
        (mlp_field.py:194-213), one-hot matmuls: on the H100 their backward
        beats a gather's, whose index_put adds every point's grads into the
        same 3 x feat_res rows (chip_smoke.py times both)."""
        if self.feat_rep == "hashgrid":
            return hash_encode(getattr(self, f"{tag}_grid"), x, spec,
                               bound=self.grid_bound)
        S = self.feat_res
        p = ((self._norm(x) + 1.0) * 0.5).clamp(0.0, 1.0) * (S - 1)
        i0 = torch.floor(p).clamp(0.0, S - 2.0)
        f = p - i0
        i0 = i0.long()
        iota = torch.arange(S, device=x.device)
        g = None
        for a, axis in enumerate("xyz"):
            ia, fa = i0[..., a, None], f[..., a, None]
            w = (torch.where(iota == ia, 1.0 - fa, 0.0)
                 + torch.where(iota == ia + 1, fa, 0.0))
            la = w @ getattr(self, f"cp_{tag}_{axis}")
            g = la if g is None else g * la
        return g @ getattr(self, f"cp_{tag}_proj")

    def mask_features(self, x):
        """[..., 3] -> [..., C] mask features (`_container_features`)."""
        return self._container_features(x, "m", self.m_spec)

    def sam_features(self, x):
        """[..., 3] -> [..., C] SAM-branch features."""
        return self._container_features(x, "s", self.s_spec)

    def apply_samvit_mlp(self, f):
        return self.samvit_norm(self.samvit_mlp(f))

    def apply_mask_mlp(self, m):
        return self.mask_mlp(m)

    # level kernels (ops/render_level.py)
    supports_fused_final = True

    def _prop_weights(self, proposal: int):
        return (self.prop_mlp_0 if proposal == 0 else self.prop_mlp_1).weights

    def fused_prop_weights(self, rays_o, rays_d, real_bins, proposal: int,
                           opaque_last: bool = True):
        """A proposal level's per-sample weights [N, T] in one kernel (K7),
        no resampling."""
        return fused_prop_level(
            rays_o, rays_d, real_bins, self._prop_weights(proposal),
            self.prop_freq_degree, self.grid_bound, opaque_last=opaque_last,
            density_bias=self.density_bias)

    def fused_prop_weights_train(self, rays_o, rays_d, real_bins,
                                 proposal: int, opaque_last: bool = True):
        """Differentiable fused_prop_weights: forward K7, backward K2."""
        return prop_level_train(
            rays_o, rays_d, real_bins, self._prop_weights(proposal),
            self.prop_freq_degree, self.grid_bound, opaque_last=opaque_last,
            density_bias=self.density_bias)

    def fused_prop_next_bins(self, rays_o, rays_d, real_bins, s_bins, u,
                             proposal: int, opaque_last: bool = True,
                             frozen: bool = False):
        """Proposal level + inverse-CDF resampling in one kernel: the NEXT
        level's s-space bin edges [N, Q].  frozen detaches the weights (the
        frozen-backbone route, where no gradient may reach them)."""
        ws = self._prop_weights(proposal)
        if frozen:
            ws = [w.detach() for w in ws]
        return fused_prop_level_sample(
            rays_o, rays_d, real_bins, s_bins, u, ws,
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

    def fused_final_render_frozen(self, rays_o, rays_d, real_bins,
                                  opaque_last: bool = True,
                                  need_geo: bool = False):
        """Final level over a frozen backbone in one kernel (K6), the
        weights detached.  Returns (f_image [N, 31], depth [N], weights_sum
        [N], weights [N, T], geo [N, T, 15] or None)."""
        sh, ws = self._final_args(rays_d)
        return fused_final_level_frozen(
            rays_o, rays_d, real_bins, sh, [w.detach() for w in ws],
            self.freq_degree, skip_layer=self.num_layers // 2,
            grid_bound=self.grid_bound, opaque_last=opaque_last,
            density_bias=self.density_bias,
            cps=[c.detach() for c in self.cp_basis], cp_res=self.cp_res,
            need_geo=need_geo)

    def fused_prop_weights_train_sample(self, rays_o, rays_d, real_bins,
                                        s_bins, u, proposal: int,
                                        opaque_last: bool = True):
        """Training twin of fused_prop_next_bins: (weights [N, T] for the
        interlevel loss, next s-space edges [N, Q], non-differentiable);
        grads reach the proposal weights through K2."""
        return prop_level_train_sample(
            rays_o, rays_d, real_bins, s_bins, u,
            self._prop_weights(proposal),
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
    """Factory: 'hashgrid' (reference parity) | 'hashgrid_packed' (corner-
    packed tables) | 'mlp' (flagship); keyword arguments the chosen field
    does not take are dropped, as the JAX factory does."""
    if field_type in ("hashgrid", "hashgrid_packed"):
        allowed = {"grid_bound", "with_sam", "with_mask", "mask_mlp_type",
                   "n_inst", "sam_use_view_direction", "main_spec",
                   "feat_spec", "prop_spec_0", "prop_spec_1", "packed"}
        kw = {k: v for k, v in kw.items() if k in allowed}
        if field_type == "hashgrid_packed":
            kw["packed"] = True
        return SANeRFField(**kw, device=device, seed=seed)
    if field_type == "mlp":
        allowed = {"grid_bound", "hidden", "num_layers", "freq_degree",
                   "prop_hidden", "prop_layers", "prop_freq_degree",
                   "density_bias", "cp_rank", "cp_res", "with_mask",
                   "n_inst", "mask_mlp_type", "feat_rep", "feat_rank",
                   "feat_res", "feat_spec", "with_sam",
                   "sam_use_view_direction"}
        return MLPField(**{k: v for k, v in kw.items() if k in allowed},
                        device=device, seed=seed)
    raise ValueError(f"unknown field_type {field_type}")
