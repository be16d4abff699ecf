"""CLI of the port: `python -m sanerf_hq_tpu_torch <scene> --test
--field_type mlp [flags]`.

The flags are the JAX CLI's that the inference path reads, plus `--device`.
`--ckpt` takes an `.npz` of JAX parameters (models/convert.py); without one
the field is initialised from `--seed`.  Results go to
`<workspace>/results/{stem}_rgb.png` and `{stem}_depth.npy`.
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from .config import Config
from .device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sanerf_hq_tpu_torch")
    p.add_argument("path", type=str)
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default="",
                   help=".npz of JAX MLPField parameters; empty = seeded init")
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_split", type=str, default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--num_steps", type=int, nargs="*", default=[128, 64, 32])
    p.add_argument("--background", type=str, default="last_sample",
                   choices=["white", "random", "last_sample"])
    p.add_argument("--max_ray_batch", type=int, default=4096 * 4)
    p.add_argument("--data_type", type=str, default="mip",
                   choices=["mip", "lerf", "llff", "3dfront", "ctr", "pano",
                            "others"])
    p.add_argument("--field_type", type=str, default="hashgrid",
                   choices=["hashgrid", "hashgrid_packed", "mlp"])
    p.add_argument("--cp_rank", type=int, default=64)
    p.add_argument("--cp_res", type=int, default=256)
    p.add_argument("--density_bias", type=float, default=0.0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda (cpu must be asked for)")
    return p


def config_from_args(args) -> Config:
    kw = {k: v for k, v in vars(args).items()
          if k in Config.__dataclass_fields__}
    kw["num_steps"] = tuple(args.num_steps)
    # post-parse hard overrides of the reference CLI
    return Config(**kw).replace(bound=128.0, contract=True)


def _subset(scene, idx):
    s = copy.copy(scene)
    s.images = scene.images[idx] if scene.images is not None else None
    s.poses = scene.poses[idx]
    s.intrinsics = (scene.intrinsics[idx] if scene.intrinsics.ndim == 2
                    else scene.intrinsics)
    s.img_names = scene.img_names[idx]
    if scene.cam_near_far is not None:
        s.cam_near_far = scene.cam_near_far[idx]
    return s


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.test:
        raise SystemExit("error: only --test is ported so far; training "
                         "comes with the next slice (ROADMAP.md)")
    device = resolve_device(cfg.device)
    # the view MLP and any plain twin stay true fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .data.provider import load_scene, split_indices
    from .models import make_field, params_from_jax
    from .train.trainer import Trainer

    model = make_field(cfg.field_type, device=device, seed=cfg.seed,
                       grid_bound=cfg.grid_bound, cp_rank=cfg.cp_rank,
                       cp_res=cfg.cp_res, density_bias=cfg.density_bias)
    trainer = Trainer("ngp", cfg, model, cfg.workspace)
    if cfg.ckpt:
        with np.load(cfg.ckpt) as npz:
            model.load_state_dict(params_from_jax(dict(npz)))
        trainer.log(f"[INFO] loaded JAX parameters from {cfg.ckpt}")
    else:
        trainer.log(f"[INFO] no --ckpt: field initialised from --seed "
                    f"{cfg.seed} (random weights)")
    model.eval()

    scene = load_scene(cfg.path, cfg.data_type, cfg.downscale, cfg.scale,
                       cfg.offset, cfg.enable_cam_center, cfg.bound)
    idx = split_indices(scene.poses.shape[0], cfg.test_split, cfg.val_type)
    trainer.test(_subset(scene, idx))
    return trainer
