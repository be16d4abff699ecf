"""Multiresolution hash-grid encoder (Instant-NGP style): K11, a
hand-written CUDA kernel pair (csrc/hashgrid.cu, one gather kernel forward
and one scatter kernel backward), and its plain PyTorch twin.

`hash_encode` routes by device (`route`): a CPU tensor goes to the twin
`hash_encode_unit`, and only a CPU tensor; a CUDA tensor launches K11
(`hash_encode_cuda`, a torch.autograd.Function) or raises.  K11 counts its
forward and backward launches in `hash_encode_cuda.launches`.  It takes
D = 3, C in {1, 2, 4, 8}, at most 16 levels, fp32 tables and points, and
no gradient to the points (no path of the port asks for one).

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

The twin's forward is `index_select` over the flat [total_params, row_dim]
table; its backward is autograd's `index_add_`.  K11 computes the same
positions and rows bit for bit and sums the eight corner products in
corner order; its backward scatters with fp32 atomics, as `index_add_`
does on the card, so table gradients vary run to run in their last bits.
(The JAX package's one-hot-matmul backward for small dense levels is a TPU
scheduling choice with the same gradient; K11 sums such levels in shared
memory where their rows fit.)  The TV and weight-decay regularisers are
ordinary differentiable losses over plain gathers.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span, time_backward
from . import cuda_lib

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


def _dense_strides(res: int, size: int, dims: int):
    """The reference's stride loop: per axis the dense stride, 0 past its
    early stop."""
    st, stride = [], 1
    for _ in range(dims):
        if stride > size:
            break
        st.append(stride)
        stride *= res
    return st + [0] * (dims - len(st))


@functools.lru_cache(maxsize=None)
def _levels(spec: HashGridSpec, levels: int, device: torch.device) -> _Levels:
    meta = spec.level_meta()[:levels]
    strides = [_dense_strides(res, size, spec.input_dim)
               for res, _, size, _ in meta]

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


def corners(x, spec: HashGridSpec, levels: int):
    """Unit-cube points x [B, D] in [0, 1] -> (table rows [levels, R, B],
    corner weights [levels, 2^D, B], fractions [levels, B, D]): R is 2^D,
    or 1 where the spec is packed (the lower corner's row, which holds
    every corner).  K11 writes the same rows and fractions on request."""
    D = spec.input_dim
    lv = _levels(spec, levels, x.device)
    lo, frac = _grid_pos(x, lv, spec)  # [levels, B, D]
    # bit d of a corner's number picks the upper neighbour along axis d
    upper = [((torch.arange(1 << D, device=x.device) >> d) & 1).bool()[:, None]
             for d in range(D)]  # [2^D, 1] each
    w = None  # trilinear weights [levels, 2^D, B]
    for d in range(D):
        f = frac[:, None, :, d]
        wd = torch.where(upper[d], f, 1.0 - f)
        w = wd if w is None else w * wd
    if spec.packed:
        rows = _index([lo[..., d] for d in range(D)], lv)[:, None]
    else:
        hi = torch.minimum(lo + 1, _per_level(lv.res, 3) - 1)
        coords = [torch.where(upper[d], hi[:, None, :, d], lo[:, None, :, d])
                  for d in range(D)]  # [levels, 2^D, B] each
        rows = _index(coords, lv)
    return rows, w, frac


def hash_encode_unit(table, x, spec: HashGridSpec,
                     max_level: Optional[int] = None):
    """K11's plain twin.  Encode unit-cube coords x [..., D] in [0, 1] ->
    [..., L * C] with table [total_params, row_dim]; levels >= max_level
    give zeros.  All levels and corners at once: one gather for the whole
    encoding."""
    D, C, L = spec.input_dim, spec.level_dim, spec.num_levels
    levels = L if max_level is None else min(max_level, L)
    prefix = x.shape[:-1]
    x = x.reshape(-1, D).float()
    B = x.shape[0]
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)  # [B, 1]
    rows, w, _ = corners(x.clamp(0.0, 1.0), spec, levels)
    vals = torch.index_select(table, 0, rows.reshape(-1))
    if spec.packed:
        vals = vals.view(levels, B, 1 << D, C).transpose(1, 2)
    else:
        vals = vals.view(levels, 1 << D, B, C)
    acc = (w[..., None] * vals.float()).sum(dim=1).to(table.dtype)
    out = acc.permute(1, 0, 2).reshape(B, levels * C)
    if levels < L:
        out = torch.cat([out, out.new_zeros(B, (L - levels) * C)], dim=-1)
    return out.masked_fill(oob, 0.0).reshape(*prefix, L * C)


# ---------------------------------------------------------------------------
# K11 (csrc/hashgrid.cu)
# ---------------------------------------------------------------------------

MAX_LEVELS = 16  # csrc/hashgrid.cu MAX_LEVELS
# a level whose gradient rows fit in this many bytes is summed in shared
# memory by the backward (csrc/hashgrid.cu SHARED_BYTES)
SHARED_BYTES = 32 * 1024
_L16 = ctypes.c_int * MAX_LEVELS
_U16 = ctypes.c_uint * MAX_LEVELS


class HashLevels(ctypes.Structure):
    """The level constants K11 takes by value (csrc/hashgrid.cu
    `HashLevels`, field for field); levels past the spec's are 0."""
    _fields_ = [("res", _L16), ("offset", _U16), ("size", _U16),
                ("stride", ctypes.c_uint * 3 * MAX_LEVELS),
                ("use_hash", _L16), ("shared", _L16)]


@functools.lru_cache(maxsize=None)
def level_struct(spec: HashGridSpec) -> HashLevels:
    """`level_meta()` and the dense strides of every level, and whether the
    backward sums the level in shared memory (its rows fit SHARED_BYTES)."""
    lv = HashLevels()
    for l, (res, offset, size, use_hash) in enumerate(spec.level_meta()):
        lv.res[l], lv.offset[l], lv.size[l] = res, offset, size
        lv.stride[l][:] = _dense_strides(res, size, spec.input_dim)
        lv.use_hash[l] = int(use_hash)
        lv.shared[l] = int(size * spec.row_dim * 4 <= SHARED_BYTES)
    return lv


@functools.lru_cache(maxsize=None)
def unsupported(spec: HashGridSpec, dtypes=(torch.float32,),
                points_need_grad: bool = False) -> Optional[str]:
    """Why K11 does not take this encode, or None where it does."""
    if spec.input_dim != 3:
        return f"input_dim {spec.input_dim} (K11 takes 3)"
    if spec.level_dim not in (1, 2, 4, 8):
        return f"level_dim {spec.level_dim} (K11 takes 1, 2, 4 or 8)"
    if spec.num_levels > MAX_LEVELS:
        return f"{spec.num_levels} levels (K11 takes at most {MAX_LEVELS})"
    if spec.total_params * spec.row_dim >= 2 ** 31:
        return f"a table of {spec.total_params} x {spec.row_dim} floats"
    if any(d != torch.float32 for d in dtypes):
        return f"dtypes {dtypes} (K11 takes float32 tables and points)"
    if points_need_grad:
        return ("a gradient to the points: no path of the port asks for "
                "one, and K11 computes none")
    return None


def route(device_type: str, spec: HashGridSpec, dtypes=(torch.float32,),
          points_need_grad: bool = False) -> str:
    """'twin' for a CPU tensor, 'k11' for a CUDA tensor K11 takes; raises
    for a CUDA tensor it does not take and for any other device."""
    if device_type == "cpu":
        return "twin"
    if device_type != "cuda":
        raise ValueError(f"hash_encode: unsupported device {device_type}")
    why = unsupported(spec, dtypes, points_need_grad)
    if why is not None:
        raise ValueError(f"hash_encode on CUDA runs K11, which does not "
                         f"take {why}")
    return "k11"


@functools.lru_cache(maxsize=None)
def _launch_args(spec: HashGridSpec, bound: float, levels: int):
    """The scalars after the pointers: levels, active, level_dim, packed,
    bound, 1 / (2 bound) in fp32 (aten divides by a scalar on the card as
    a product with its fp32 reciprocal), align_corners, smoothstep, and
    the level struct."""
    inv = float(np.float32(1.0) / np.float32(2.0 * bound))
    return (spec.num_levels, levels, spec.level_dim, int(spec.packed),
            float(bound), inv, int(spec.align_corners),
            int(spec.interpolation == "smoothstep"),
            ctypes.byref(level_struct(spec)))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SCALARS = [ctypes.c_longlong, _I, _I, _I, _I, _F, _F, _I, _I,
            ctypes.POINTER(HashLevels), _P]


def _cfn(name: str, n_ptr: int):
    lib = cuda_lib.load("hashgrid")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptr + _SCALARS
        fn.restype = _I
    return lib, fn


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _table_shape(spec: HashGridSpec):
    return spec.total_params, spec.row_dim


def _check(name, t, shape, device, align: int = 16):
    """Raise unless t is fp32 on device, of this shape, contiguous and
    aligned for K11's vector loads."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         "aligned")


def _fwd(table, x, spec: HashGridSpec, bound: float, levels: int,
         debug: bool = False):
    """K11's forward launch: x [B, 3] -> [B, L * C] (and, with debug, the
    corner rows [levels, R, B] int32 and fractions [levels, B, 3])."""
    B, dev = x.shape[0], x.device
    out = torch.empty((B, spec.output_dim), dtype=torch.float32, device=dev)
    rows = frac = None
    if debug:
        rows = torch.empty((levels, 1 if spec.packed else 8, B),
                           dtype=torch.int32, device=dev)
        frac = torch.empty((levels, B, 3), dtype=torch.float32, device=dev)
    if B == 0:
        return out, rows, frac
    lib, fn = _cfn("sanerf_hash_encode_fwd", 5)
    rc = fn(_ptr(x), _ptr(table), _ptr(out), _ptr(rows), _ptr(frac), B,
            *_launch_args(spec, bound, levels), _stream(dev))
    cuda_lib.check(lib, rc, "hash_encode (K11 forward)")
    hash_encode_cuda.launches += 1
    return out, rows, frac


def _bwd(x, grad_out, table_shape, spec: HashGridSpec, bound: float,
         levels: int):
    """K11's backward launch: dL/dout [B, L * C] -> the dense fp32 table
    gradient [total_params, row_dim]."""
    grad = torch.zeros(table_shape, dtype=torch.float32, device=x.device)
    if x.shape[0] == 0 or levels == 0:
        return grad
    _check("grad_out", grad_out, (x.shape[0], spec.output_dim), x.device)
    lib, fn = _cfn("sanerf_hash_encode_bwd", 3)
    rc = fn(_ptr(x), _ptr(grad_out), _ptr(grad), x.shape[0],
            *_launch_args(spec, bound, levels), _stream(x.device))
    cuda_lib.check(lib, rc, "hash_encode (K11 backward)")
    hash_encode_cuda.launches += 1
    return grad


class _HashEncodeK11(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, spec, bound, levels):
        ctx.save_for_backward(x)
        ctx.meta = (table.shape, spec, bound, levels)
        return _fwd(table, x, spec, bound, levels)[0]

    @staticmethod
    def backward(ctx, grad_out):
        (x,) = ctx.saved_tensors
        shape, spec, bound, levels = ctx.meta
        grad = None
        if ctx.needs_input_grad[0]:
            g = grad_out.contiguous()
            if g.data_ptr() % 16:  # a view into another buffer
                g = g.clone()
            grad = _bwd(x, g, shape, spec, bound, levels)
        return grad, None, None, None, None


def hash_encode_cuda(table, x, spec: HashGridSpec, bound: float = 1.0,
                     max_level: Optional[int] = None, debug: bool = False):
    """K11: world coords x [..., 3] in [-bound, bound] on the card ->
    [..., L * C], differentiable in the table.  With debug (no gradient),
    (out, corner rows [levels, R, B], fractions [levels, B, 3]) for the
    card test."""
    points_need_grad = torch.is_grad_enabled() and x.requires_grad
    route(x.device.type, spec, (table.dtype, x.dtype), points_need_grad)
    L = spec.num_levels
    levels = L if max_level is None else min(max_level, L)
    if levels < 0:
        raise ValueError(f"max_level {max_level} is negative")
    prefix = x.shape[:-1]
    xf = x.detach().reshape(-1, spec.input_dim).contiguous()
    _check("x", xf, xf.shape, table.device, align=4)
    _check("table", table, _table_shape(spec), table.device)
    if debug:
        with torch.no_grad():
            return _fwd(table, xf, spec, bound, levels, debug=True)
    if torch.is_grad_enabled() and table.requires_grad:
        out = _HashEncodeK11.apply(table, xf, spec, float(bound), levels)
    else:  # nothing to differentiate: no graph
        out = _fwd(table, xf, spec, float(bound), levels)[0]
    return out.reshape(*prefix, spec.output_dim)


hash_encode_cuda.launches = 0


def hash_encode(table, x, spec: HashGridSpec, bound: float = 1.0,
                max_level: Optional[int] = None):
    """Encode world coords in [-bound, bound]: K11 on the card, the twin
    on the CPU (`route`).  The span `sanerf.encode` times the forward and,
    where the table learns, its backward."""
    with span("sanerf.encode") as rec:
        if x.device.type != "cpu":  # K11, or its refusal
            out = hash_encode_cuda(table, x, spec, bound, max_level)
        else:
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
