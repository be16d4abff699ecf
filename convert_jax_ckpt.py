#!/usr/bin/env python3
"""Carry a JAX workspace's field over to the PyTorch port.

    python convert_jax_ckpt.py <jax workspace> out.npz [--which latest|best|<path>] [--ema]

Restores the orbax checkpoint of a `python main.py` workspace with the JAX
package's `CheckpointManager` (`latest`, the default, `best`, or an
explicit checkpoint directory) and writes its `params` (with `--ema` its
`ema_params`, the weights the stage-1 eval renders) as a flat `.npz`, one
`/`-joined key a leaf.  That is the file the port's `models/convert.py`
`params_from_jax` reads:

    python -m sanerf_hq_tpu_torch <scene> --test --ckpt out.npz ...
    python -m sanerf_hq_tpu_torch <scene> --with_mask --init_ckpt out.npz ...

This script runs under JAX and is no part of the port's package.
"""
import argparse
import os
import sys

import numpy as np


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def convert(workspace: str, out: str, which: str = "latest",
            ema: bool = False) -> dict:
    """Write the checkpoint's parameters to `out`; returns the flat dict."""
    from sanerf_hq_tpu.train.checkpoints import CheckpointManager

    if not os.path.isdir(os.path.join(workspace, "checkpoints")):
        raise FileNotFoundError(f"{workspace}: no checkpoints/ directory")
    restored = CheckpointManager(workspace).restore(which)
    if restored is None:
        raise FileNotFoundError(f"{workspace}: no checkpoint {which!r}")
    flat = flatten(restored["ema_params" if ema else "params"])
    np.savez(out, **flat)
    return flat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workspace")
    p.add_argument("out", help="the .npz to write")
    p.add_argument("--which", default="latest",
                   help="latest, best or a checkpoint directory")
    p.add_argument("--ema", action="store_true",
                   help="write ema_params instead of params")
    args = p.parse_args(argv)
    flat = convert(args.workspace, args.out, args.which, args.ema)
    print(f"[INFO] wrote {len(flat)} arrays "
          f"({'ema_params' if args.ema else 'params'}) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
