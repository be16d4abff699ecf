"""The reference-parity field: Instant-NGP hash-grid radiance field with two
hash-grid proposal networks (`--field_type hashgrid`, the CLI default, and
`hashgrid_packed`), and its stage-3 object field (`with_mask`).

Published widths (nerf/network.py of the reference):
  - main grid: 16 levels x 2 channels, 2^19 table, base 16, desired
    resolution 2048 * grid_bound; grid_mlp 32 -> 64 -> 64 -> 1 + 15,
    bias-free; density trunc_exp of its first output;
  - view branch: SH degree 4; view_mlp 15 + 16 -> 32 -> 32 -> 3, bias-free,
    applied after compositing (deferred colour);
  - proposal nets: 5 levels x 2 channels, 2^17 table, desired resolution
    128 and 256, each with an MLP 10 -> 16 -> 1, bias-free.
  - object field (stage 3): the mask table `m_grid` at
    `feature_grid_spec()` (16 levels x 8 channels, 2^19, resolution 512;
    `feat_spec` overrides it) with mask_mlp a bias-free SkipConnMLP 128 +
    15 -> 256 x 3 -> n_inst on [features | geo_feat]; or, with
    mask_mlp_type 'lightweight_mask', at `lightweight_mask_grid_spec()`
    (16 x 2, 2^10, resolution 256, never packed) with a bias-free MLP 32 +
    15 + 16 -> 64 x 3 -> n_inst on [features | colour].  They are drawn
    after the backbone, so a seed gives the same backbone with or without
    them.
The field has no level kernels, so the renderer takes its composable route
(whose `sample_pdf` runs K10 on the card).  `packed` stores each grid
cell's 8 corner rows in one table row (8x the memory).

Parameter names follow the JAX field's flax tree: `grid`, `prop_grid_0`,
`prop_grid_1`, `m_grid` (tables [rows, row_dim]), `grid_mlp`, `view_mlp`,
`prop_mlp_0`, `prop_mlp_1`, `mask_mlp` (`MLP`s with [out, in] weights).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.hashgrid import HashGridSpec, hash_encode, init_hash_table
from ..ops.sh import sh_encode
from ..ops.trunc_exp import trunc_exp
from .mlp import MLP, SkipConnMLP

GEOM_FEAT_DIM = 15
SH_DEGREE = 4
SH_DIM = SH_DEGREE * SH_DEGREE


def main_grid_spec(grid_bound: float) -> HashGridSpec:
    return HashGridSpec(
        input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
        log2_hashmap_size=19, desired_resolution=int(2048 * grid_bound),
    )


def feature_grid_spec() -> HashGridSpec:
    """s_grid / m_grid (stages 2 and 3)."""
    return HashGridSpec(
        input_dim=3, num_levels=16, level_dim=8, base_resolution=16,
        log2_hashmap_size=19, desired_resolution=512,
    )


def lightweight_mask_grid_spec() -> HashGridSpec:
    return HashGridSpec(
        input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
        log2_hashmap_size=10, desired_resolution=256,
    )


def prop_grid_spec(desired_resolution: int) -> HashGridSpec:
    return HashGridSpec(
        input_dim=3, num_levels=5, level_dim=2, base_resolution=16,
        log2_hashmap_size=17, desired_resolution=desired_resolution,
    )


def mask_grid_spec(mask_mlp_type: str = "default",
                   feat_spec: Optional[HashGridSpec] = None,
                   packed: bool = False) -> HashGridSpec:
    """The spec of the object field's table `m_grid`: feat_spec or
    feature_grid_spec() with the default mask MLP, corner-packed when the
    field is; lightweight_mask_grid_spec() with the lightweight one, never
    packed."""
    if mask_mlp_type == "default":
        spec = feat_spec or feature_grid_spec()
        return dataclasses.replace(spec, packed=True) if packed else spec
    if mask_mlp_type == "lightweight_mask":
        return lightweight_mask_grid_spec()
    raise ValueError(f"unknown mask_mlp_type {mask_mlp_type}")


def active_reg_grid(model, stage: str):
    """The hash table that --lambda_tv / --lambda_wd regularise in a stage
    ('rgb' | 'sam' | 'mask'): (parameter name, spec), or None when the
    model has none for it (the MLP field; a field without the stage's
    table; stage 2, not ported)."""
    if not isinstance(model, SANeRFField) or stage == "sam":
        return None
    if stage == "mask":
        return ("m_grid", model.m_spec) if model.with_mask else None
    return "grid", model.grid_spec


class SANeRFField(nn.Module):
    def __init__(self, grid_bound: float = 2.0, with_sam: bool = False,
                 with_mask: bool = False, mask_mlp_type: str = "default",
                 n_inst: int = 2,
                 main_spec: Optional[HashGridSpec] = None,
                 feat_spec: Optional[HashGridSpec] = None,
                 prop_spec_0: Optional[HashGridSpec] = None,
                 prop_spec_1: Optional[HashGridSpec] = None,
                 packed: bool = False, device=None, seed: int = 0):
        super().__init__()
        if with_sam:
            raise NotImplementedError(
                "with_sam (stage 2) is not ported yet (ROADMAP.md, queue 1, "
                "M8)")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.grid_bound = grid_bound
        self.packed = packed

        def pack(spec):
            return dataclasses.replace(spec, packed=True) if packed else spec

        self.grid_spec = pack(main_spec or main_grid_spec(grid_bound))
        self.grid = nn.Parameter(init_hash_table(g, self.grid_spec, device))
        self.grid_mlp = MLP(self.grid_spec.output_dim, 1 + GEOM_FEAT_DIM, 64,
                            3, device=device, generator=g)
        self.view_mlp = MLP(GEOM_FEAT_DIM + SH_DIM, 3, 32, 3, device=device,
                            generator=g)
        self.prop_specs = (pack(prop_spec_0 or prop_grid_spec(128)),
                           pack(prop_spec_1 or prop_grid_spec(256)))
        self.prop_grid_0 = nn.Parameter(
            init_hash_table(g, self.prop_specs[0], device))
        self.prop_grid_1 = nn.Parameter(
            init_hash_table(g, self.prop_specs[1], device))
        self.prop_mlp_0 = MLP(self.prop_specs[0].output_dim, 1, 16, 2,
                              device=device, generator=g)
        self.prop_mlp_1 = MLP(self.prop_specs[1].output_dim, 1, 16, 2,
                              device=device, generator=g)
        self.with_mask = with_mask
        self.mask_mlp_type = mask_mlp_type
        self.n_inst = n_inst
        if with_mask:  # drawn last: the backbone's init does not depend on it
            self.m_spec = mask_grid_spec(mask_mlp_type, feat_spec, packed)
            self.m_grid = nn.Parameter(init_hash_table(g, self.m_spec, device))
            C = self.m_spec.output_dim
            if mask_mlp_type == "default":
                self.mask_mlp = SkipConnMLP(C + GEOM_FEAT_DIM, n_inst, 256, 3,
                                            use_bias=False, device=device,
                                            generator=g)
            else:
                self.mask_mlp = MLP(C + GEOM_FEAT_DIM + SH_DIM, n_inst, 64, 3,
                                    device=device, generator=g)

    def common_forward(self, x):
        """x [..., 3] contracted coords in [-grid_bound, grid_bound] ->
        (sigma [...], geo_feat [..., 15], grid_output [..., 32])."""
        grid_output = hash_encode(self.grid, x, self.grid_spec,
                                  bound=self.grid_bound)
        f = self.grid_mlp(grid_output)
        return trunc_exp(f[..., 0]), f[..., 1:], grid_output

    def density(self, x, proposal: int = -1):
        """Density; proposal 0 or 1 routes to the proposal nets."""
        if proposal in (0, 1):
            table = self.prop_grid_0 if proposal == 0 else self.prop_grid_1
            mlp = self.prop_mlp_0 if proposal == 0 else self.prop_mlp_1
            h = hash_encode(table, x, self.prop_specs[proposal],
                            bound=self.grid_bound)
            return trunc_exp(mlp(h)[..., 0])
        sigma, _, _ = self.common_forward(x)
        return sigma

    def forward_color(self, x, d):
        """Final-level query, d normalised: (sigma, geo_feat, colour, the
        grid output); the colour is the pre-MLP per-sample feature
        [geo_feat | SH(d)], the view MLP runs after compositing."""
        sigma, feat, grid_output = self.common_forward(x)
        color = torch.cat([feat, sh_encode(d, SH_DEGREE)], dim=-1)
        return sigma, feat, color, grid_output

    def apply_view_mlp(self, f_image):
        return self.view_mlp(f_image)

    def mask_features(self, x):
        """Contracted coords [..., 3] -> the m_grid encoding [..., C]."""
        return hash_encode(self.m_grid, x, self.m_spec, bound=self.grid_bound)

    def apply_mask_mlp(self, m):
        return self.mask_mlp(m)
