"""Operations and bytes of the cells' work, counted from the algorithm's
shapes (the configuration's widths and sample counts), whatever
implements it, and the published peaks of one H100 SXM they are held to.

Model FLOPs: 2 a multiply-add; the forward of every layer on the path; in
training the backward where parameters learn or gradients must flow (the
weight products, and the input products of every layer whose input needs
a gradient); nothing recomputed is counted.  The hash encoder counts its
trilinear blend (8 corners x channels a level) forward and its scatter
backward.

Roofline bytes: each input read once, each output written once."""
from __future__ import annotations

from typing import List, Tuple

PEAK_BF16 = 989e12  # FLOP/s, dense tensor cores
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3


def mlp_dims(inp: int, hidden: int, layers: int, out: int,
             skip: int = None) -> List[Tuple[int, int]]:
    dims = [inp] + [hidden] * (layers - 1) + [out]
    return [(dims[l] + (inp if l == skip else 0), dims[l + 1])
            for l in range(layers)]


def macs(layers) -> int:
    return sum(i * o for i, o in layers)


def _train_macs(layers, grad_cols0: int) -> int:
    """Forward, weight-gradient and input-gradient MACs of an MLP whose
    layer 0 needs the gradient of grad_cols0 of its input columns."""
    fwd = macs(layers)
    igrad = macs(layers[1:]) + grad_cols0 * layers[0][1]
    return 2 * fwd + igrad


def _grid_width(spec) -> int:
    return spec["num_levels"] * spec["level_dim"]


def _enc(spec) -> int:
    return 8 * _grid_width(spec)


class MLPFieldCounts:
    def __init__(self, field: dict):
        f = field
        self.T = f["num_steps"]
        self.pdeg, self.deg, self.rank = (f["prop_freq_degree"],
                                          f["freq_degree"], f["cp_rank"])
        self.pin = 3 * (1 + 2 * self.pdeg)
        self.tin = 3 * (1 + 2 * self.deg) + self.rank
        self.prop = mlp_dims(self.pin, f["prop_hidden"], f["prop_layers"], 1)
        self.trunk = mlp_dims(self.tin, f["hidden"], f["num_layers"], 16,
                              skip=f["num_layers"] // 2)
        v = f["view_mlp"]
        self.view = mlp_dims(31, v["hidden"], v["layers"], 3)
        self.cp_res = f["cp_res"]
        self.cp_macs = 8 * self.rank  # 3 axes x 2 taps, then 2 products

    def forward_flops(self, rays: int) -> float:
        p = sum(self.T[:-1]) * macs(self.prop)
        t = self.T[-1] * (macs(self.trunk) + self.cp_macs)
        return 2.0 * rays * (p + t + macs(self.view))

    def train_flops(self, rays: int, update_proposal: bool = True) -> float:
        p = sum(self.T[:-1]) * (_train_macs(self.prop, 0) if update_proposal
                                else macs(self.prop))
        t = self.T[-1] * (_train_macs(self.trunk, self.rank)
                          + 2 * self.cp_macs)
        return 2.0 * rays * (p + t + _train_macs(self.view, 31))

    # -- the level kernels: (bytes, bf16 FLOPs, fp32 ops) ------------------
    def prop_fwd(self, n, T, Q, weights_out):
        b = 4 * n * (6 + 2 * (T + 1) + Q + Q) + 2 * macs(self.prop)
        if weights_out:
            b += 4 * n * T
        return b, 2.0 * n * T * macs(self.prop), 2.0 * n * T * 3 * self.pdeg

    def prop_bwd(self, n, T):
        b = 4 * n * (6 + (T + 1) + T) + 2 * macs(self.prop) \
            + 4 * macs(self.prop)
        return b, 2.0 * n * T * (macs(self.prop) + macs(self.prop[1:])), 0.0

    def final_fwd(self, n, weights_out):
        T = self.T[-1]
        cps = 4 * 3 * self.cp_res * self.rank
        b = 4 * n * (6 + (T + 1) + 16 + 31 + 2) + 2 * macs(self.trunk) + cps
        if weights_out:
            b += 4 * n * T
        return (b, 2.0 * n * T * macs(self.trunk),
                2.0 * n * T * (3 * self.deg + self.cp_macs))

    def final_bwd(self, n):
        T = self.T[-1]
        cps = 4 * 3 * self.cp_res * self.rank
        b = (4 * n * (6 + (T + 1) + 16 + 31 + 2 + T) + 2 * macs(self.trunk)
             + 2 * cps + 4 * macs(self.trunk))
        igrad = macs(self.trunk[1:]) + self.rank * self.trunk[0][1]
        return (b, 2.0 * n * T * (macs(self.trunk) + igrad),
                2.0 * n * T * 2 * self.cp_macs)

    def level_train(self, n):
        T = self.T
        return ([self.prop_fwd(n, T[l], T[l + 1] + 1, True)
                 for l in range(len(T) - 1)]
                + [self.prop_bwd(n, T[l]) for l in range(len(T) - 1)]
                + [self.final_fwd(n, True), self.final_bwd(n)])

    def level_render(self, n):
        T = self.T
        return ([self.prop_fwd(n, T[l], T[l + 1] + 1, False)
                 for l in range(len(T) - 1)] + [self.final_fwd(n, False)])


class HashFieldCounts:
    def __init__(self, field: dict):
        f = field
        self.T = f["num_steps"]
        self.main, self.props = f["main_grid"], f["prop_grids"]
        g, pm, v = f["grid_mlp"], f["prop_mlp"], f["view_mlp"]
        self.grid_mlp = mlp_dims(_grid_width(self.main), g["hidden"],
                                 g["layers"], 16)
        self.prop_mlps = [mlp_dims(_grid_width(s), pm["hidden"],
                                   pm["layers"], 1) for s in self.props]
        self.view = mlp_dims(31, v["hidden"], v["layers"], 3)
        self.mask = f.get("mask_grid")
        if self.mask is not None:
            mm_ = f["mask_mlp"]
            self.mask_mlp = mlp_dims(_grid_width(self.mask) + 15,
                                     mm_["hidden"], mm_["layers"],
                                     f["n_inst"])

    def _backbone(self, train: bool) -> float:
        tot = 0.0
        for l, T in enumerate(self.T[:-1]):
            mlp = self.prop_mlps[l]
            tot += T * ((2 * _enc(self.props[l]) + _train_macs(
                mlp, _grid_width(self.props[l]))) if train
                else _enc(self.props[l]) + macs(mlp))
        T = self.T[-1]
        tot += T * ((2 * _enc(self.main) + _train_macs(
            self.grid_mlp, _grid_width(self.main))) if train
            else _enc(self.main) + macs(self.grid_mlp))
        return tot + (_train_macs(self.view, 31) if train
                      else macs(self.view))

    def forward_flops(self, rays: int) -> float:
        return 2.0 * rays * self._backbone(False)

    def train_flops(self, rays: int) -> float:
        return 2.0 * rays * self._backbone(True)

    def mask_train_flops(self, rays: int) -> float:
        """Stage 3: the frozen backbone forward, the object field trained."""
        T = self.T[-1]
        m = T * (2 * _enc(self.mask) + _train_macs(
            self.mask_mlp, _grid_width(self.mask)))
        return 2.0 * rays * (self._backbone(False) + m)


def counts_for(field: dict):
    return (MLPFieldCounts(field) if field["type"] == "mlp"
            else HashFieldCounts(field))


def bound_s(parts) -> float:
    """Least time of a list of (bytes, bf16 FLOPs, fp32 ops) kernels: each
    the larger of its bytes over the memory rate and its operations over
    the peak rate of their type."""
    return sum(max(b / PEAK_BYTES, f / PEAK_BF16, o / PEAK_FP32)
               for b, f, o in parts)
