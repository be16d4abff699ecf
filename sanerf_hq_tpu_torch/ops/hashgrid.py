"""Multiresolution hash-grid encoder (Instant-NGP style), plain PyTorch.

Semantics of the reference encoder (gridencoder):
  - level l has resolution R_l = ceil(base * scale^l), computed in float64
    with numpy exactly as the JAX package computes it (the main grid's last
    level is 4097, not 4096);
  - a level's table holds min(2^log2_hashmap_size, R^D) rows rounded up to
    a multiple of 8;
  - dense indexing while R^D fits in the level's table, else the spatial
    hash xor(pos_d * prime_d) mod size in uint32 arithmetic (computed here
    in int64, each product masked to 32 bits);
  - align_corners=False: pos = clip(x * R - 0.5, 0, R - 1); True:
    pos = x * (R - 1) with the lower corner at most R - 2;
  - points outside [0, 1] give zero output and zero gradient;
  - linear or smoothstep corner weights; levels >= max_level give zeros;
  - tables initialised U(-1e-4, 1e-4).
The packed variant stores a cell's 2^D corner rows in one table row, so a
lookup is one gather a level.

The forward is `index_select` over the flat [total_params, row_dim] table;
its backward is autograd's `index_add_`, which on the card sums with fp32
atomics, so table gradients vary run to run in their last bits.  (The JAX
package's one-hot-matmul backward for small dense levels is a TPU
scheduling choice with the same gradient; it has no counterpart here.)
The TV and weight-decay regularisers are ordinary differentiable losses.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span, time_backward

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: Optional[int] = None
    gridtype: str = "hash"  # "hash" | "tiled"
    interpolation: str = "linear"  # "linear" | "smoothstep"
    align_corners: bool = False
    # each table row holds all 2^D corner features of one cell (8x memory,
    # one gather a level); another function class than the NGP encoder
    packed: bool = False

    @property
    def scale(self) -> float:
        if self.desired_resolution is not None:
            return float(
                np.exp2(
                    np.log2(self.desired_resolution / self.base_resolution)
                    / (self.num_levels - 1)
                )
            )
        return float(self.per_level_scale)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def max_params(self) -> int:
        return 2 ** self.log2_hashmap_size

    def level_meta(self) -> Tuple[Tuple[int, int, int, bool], ...]:
        """Per level: (resolution, offset, size, use_hash)."""
        meta = []
        offset = 0
        for lvl in range(self.num_levels):
            res = int(np.ceil(self.base_resolution * self.scale ** lvl))
            size = min(self.max_params, res ** self.input_dim)
            size = int(np.ceil(size / 8) * 8)
            # the reference's stride loop decides dense vs hash
            stride = 1
            for _ in range(self.input_dim):
                if stride > size:
                    break
                stride *= res
            use_hash = self.gridtype == "hash" and stride > size
            meta.append((res, offset, size, use_hash))
            offset += size
        return tuple(meta)

    @property
    def total_params(self) -> int:
        meta = self.level_meta()
        return meta[-1][1] + meta[-1][2]

    @property
    def row_dim(self) -> int:
        return self.level_dim * (2 ** self.input_dim if self.packed else 1)


def init_hash_table(generator: torch.Generator, spec: HashGridSpec,
                    device=None) -> torch.Tensor:
    """U(-1e-4, 1e-4) table [total_params, row_dim], drawn on the CPU from
    `generator` and moved to `device`."""
    t = torch.rand((spec.total_params, spec.row_dim), generator=generator)
    return (t * 2e-4 - 1e-4).to(device)


class _Levels(NamedTuple):
    """Constants of a spec's first levels as tensors [levels]: resolution
    (float and int), offset, size, use_hash, and the dense strides [D,
    levels] (the reference's stride loop, 0 past its early stop)."""
    res_f: torch.Tensor
    res: torch.Tensor
    offset: torch.Tensor
    size: torch.Tensor
    use_hash: torch.Tensor
    strides: torch.Tensor


@functools.lru_cache(maxsize=None)
def _levels(spec: HashGridSpec, levels: int, device: torch.device) -> _Levels:
    meta = spec.level_meta()[:levels]
    strides = []
    for res, _, size, _ in meta:
        st, stride = [], 1
        for _ in range(spec.input_dim):
            if stride > size:
                break
            st.append(stride)
            stride *= res
        strides.append(st + [0] * (spec.input_dim - len(st)))

    def t(values, dtype=torch.int64):
        return torch.tensor(values, dtype=dtype, device=device)

    return _Levels(t([m[0] for m in meta], torch.float32),
                   t([m[0] for m in meta]), t([m[1] for m in meta]),
                   t([m[2] for m in meta]), t([m[3] for m in meta],
                                              torch.bool),
                   t(strides).t().contiguous())


def _per_level(v, ndim: int):
    """[levels] -> [levels, 1, ...] against a tensor of ndim dims."""
    return v.view(-1, *([1] * (ndim - 1)))


def _index(coords, lv: _Levels):
    """coords: D int64 grid-coordinate tensors [levels, ...], one an axis
    -> table rows [levels, ...]: the reference's get_grid_index (spatial
    hash or dense strides, both in uint32 arithmetic) plus the offset."""
    n = coords[0].dim()
    hashed = dense = 0
    for d, c in enumerate(coords):
        hashed = hashed ^ ((c * _PRIMES[d]) & _U32)
        dense = dense + c * _per_level(lv.strides[d], n)
    idx = torch.where(_per_level(lv.use_hash, n), hashed, dense & _U32)
    return idx % _per_level(lv.size, n) + _per_level(lv.offset, n)


def _grid_pos(x, lv: _Levels, spec: HashGridSpec):
    """Lower corners [levels, B, D] int64 and the interpolation fractions
    [levels, B, D] of unit-cube points x [B, D]."""
    res = _per_level(lv.res_f, 3)
    if spec.align_corners:
        pos = x * (res - 1)
        pos_grid = torch.minimum(torch.floor(pos), res - 2)
    else:
        pos = torch.minimum((x * res - 0.5).clamp_min(0.0), res - 1)
        pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    return pos_grid.long(), frac


def hash_encode_unit(table, x, spec: HashGridSpec,
                     max_level: Optional[int] = None):
    """Encode unit-cube coords x [..., D] in [0, 1] -> [..., L * C] with
    table [total_params, row_dim]; levels >= max_level give zeros.  All
    levels and corners at once: one gather for the whole encoding."""
    D, C, L = spec.input_dim, spec.level_dim, spec.num_levels
    levels = L if max_level is None else min(max_level, L)
    prefix = x.shape[:-1]
    x = x.reshape(-1, D).float()
    B = x.shape[0]
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)  # [B, 1]
    lv = _levels(spec, levels, x.device)
    lo, frac = _grid_pos(x.clamp(0.0, 1.0), lv, spec)  # [levels, B, D]
    # bit d of a corner's number picks the upper neighbour along axis d
    upper = [((torch.arange(1 << D, device=x.device) >> d) & 1).bool()[:, None]
             for d in range(D)]  # [2^D, 1] each
    w = None  # trilinear weights [levels, 2^D, B]
    for d in range(D):
        f = frac[:, None, :, d]
        wd = torch.where(upper[d], f, 1.0 - f)
        w = wd if w is None else w * wd
    if spec.packed:
        rows = _index([lo[..., d] for d in range(D)], lv)  # [levels, B]
        vals = torch.index_select(table, 0, rows.reshape(-1))
        vals = vals.view(levels, B, 1 << D, C).transpose(1, 2)
    else:
        hi = torch.minimum(lo + 1, _per_level(lv.res, 3) - 1)
        coords = [torch.where(upper[d], hi[:, None, :, d], lo[:, None, :, d])
                  for d in range(D)]  # [levels, 2^D, B] each
        vals = torch.index_select(table, 0, _index(coords, lv).reshape(-1))
        vals = vals.view(levels, 1 << D, B, C)
    acc = (w[..., None] * vals.float()).sum(dim=1).to(table.dtype)
    out = acc.permute(1, 0, 2).reshape(B, levels * C)
    if levels < L:
        out = torch.cat([out, out.new_zeros(B, (L - levels) * C)], dim=-1)
    return out.masked_fill(oob, 0.0).reshape(*prefix, L * C)


def hash_encode(table, x, spec: HashGridSpec, bound: float = 1.0,
                max_level: Optional[int] = None):
    """Encode world coords in [-bound, bound].  The span `sanerf.encode`
    times the forward and, where the table learns, its backward."""
    with span("sanerf.encode") as rec:
        x = (x + bound) / (2.0 * bound)
        out = hash_encode_unit(table, x, spec, max_level=max_level)
    time_backward(rec, out, table)
    return out


# ---------------------------------------------------------------------------
# Regularisers as differentiable losses
# ---------------------------------------------------------------------------

def total_variation_loss_at(table, spec: HashGridSpec, x):
    """Total variation of the grid at unit-cube points x [n, D]: at each
    point and level, the squared difference between the lower corner's row
    and its neighbour's along each axis, summed, over n."""
    D = spec.input_dim
    lv = _levels(spec, spec.num_levels, x.device)
    lo, _ = _grid_pos(x, lv, spec)
    coords = [lo[..., d] for d in range(D)]  # [L, n] each
    base = torch.index_select(table, 0, _index(coords, lv).reshape(-1))
    loss = 0.0
    for d in range(D):
        nb = list(coords)
        nb[d] = torch.minimum(coords[d] + 1, _per_level(lv.res, 2) - 1)
        nb_val = torch.index_select(table, 0, _index(nb, lv).reshape(-1))
        loss = loss + ((base - nb_val) ** 2).sum()
    return loss / x.shape[0]


def total_variation_loss(table, spec: HashGridSpec,
                         generator: Optional[torch.Generator] = None,
                         n_samples: int = 8192):
    """Stochastic total variation at n_samples uniform points drawn from
    `generator` (on the table's device)."""
    x = torch.rand((n_samples, spec.input_dim), generator=generator,
                   device=table.device)
    return total_variation_loss_at(table, spec, x)


def weight_decay_loss(table, spec: HashGridSpec):
    """Level-size-normalised L2 decay: each level's squared norm over its
    row count."""
    loss = 0.0
    for _, offset, size, _ in spec.level_meta():
        loss = loss + (table[offset:offset + size] ** 2).sum() / size
    return loss
