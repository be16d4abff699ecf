"""Carry weights across from the JAX package.

`params_from_jax` takes the flax parameter tree of an `MLPField` or a
`SANeRFField` as numpy arrays, nested (`jax.device_get(params)`) or
flattened with `/` keys as in an `.npz` written by `save_npz`, and returns
the port's `state_dict`.  flax
kernels are [in, out]; they are transposed once here into the port's
[out, in] layout.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_RULES = (
    # (flax path, port key template, transpose)
    (re.compile(r"(trunk|prop_mlp_[01])/(w\d+)"), r"\1.\2", True),
    (re.compile(r"(cp_[xyz])"), r"\1", False),
    # the hash tables [rows, row_dim] keep their layout: the hash-grid
    # field's, and the object field's m_grid (either field)
    (re.compile(r"(grid|prop_grid_[01]|m_grid)"), r"\1", False),
    (re.compile(r"(view_mlp|mask_mlp|grid_mlp|prop_mlp_[01])/Dense_(\d+)"
                r"/kernel"), r"\1.layers.\2.weight", True),
    (re.compile(r"mask_mlp/Dense_(\d+)/bias"), r"mask_mlp.layers.\1.bias",
     False),
    (re.compile(r"(cp_m_[xyz]|cp_m_proj)"), r"\1", False),
)


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested mapping -> {'a/b/c': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def save_npz(path: str, tree: Mapping):
    """Write a (nested) parameter tree of numpy arrays as a flat `.npz`."""
    np.savez(path, **{k: np.asarray(v) for k, v in flatten(tree).items()})


def params_from_jax(tree: Mapping) -> dict:
    """Flax MLPField or SANeRFField parameters -> the port's state_dict
    (CPU float32).

    Keys: params/trunk/w0..w3, params/cp_x|cp_y|cp_z,
    params/prop_mlp_{0,1}/w0..w2, params/view_mlp/Dense_{0,1,2}/kernel;
    the hash-grid field's params/grid|prop_grid_0|prop_grid_1 and
    params/grid_mlp|prop_mlp_{0,1}/Dense_i/kernel (patterns match whole
    keys, so the two fields' `prop_mlp_*` forms never meet);
    and the stage-3 mask branch: params/cp_m_x|cp_m_y|cp_m_z|cp_m_proj or
    params/m_grid, params/mask_mlp/Dense_i/kernel (and bias where it
    exists), of either mask MLP of either field.  Leaves of
    the stage-2 heads (cp_s_*, samvit_*) are not carried; a strict
    `load_state_dict` reports anything the field still lacks."""
    flat = flatten(tree) if any(isinstance(v, Mapping) for v in tree.values()) \
        else dict(tree)
    state = {}
    for key, value in flat.items():
        path = key[len("params/"):] if key.startswith("params/") else key
        for pattern, template, transpose in _RULES:
            m = pattern.fullmatch(path)
            if m:
                arr = np.asarray(value, dtype=np.float32)
                if transpose:
                    arr = arr.T
                state[m.expand(template)] = torch.tensor(arr)
                break
    return state
