"""CLI of the port: `python -m sanerf_hq_tpu_torch <scene> --field_type mlp
[flags]` trains stage 1 (then evaluates PSNR and SSIM into
`<workspace>/validation/`); with `--test` it renders the held-out views
into `<workspace>/results/{stem}_rgb.png` and `{stem}_depth.npy`.

The flags are the JAX CLI's that the stage-1 path reads, plus `--device`.
`--ckpt latest` (the default) resumes the newest checkpoint in
`<workspace>/checkpoints`; `--ckpt` also takes an `.npz` of JAX parameters
(models/convert.py).  Otherwise the field is initialised from `--seed`.
"""
from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

from .config import Config
from .device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sanerf_hq_tpu_torch")
    p.add_argument("path", type=str)
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default="latest",
                   help="latest (resume the workspace) or an .npz of JAX "
                        "MLPField parameters")
    p.add_argument("--save_cnt", type=int, default=20)
    p.add_argument("--eval_cnt", type=int, default=5)
    p.add_argument("--test", action="store_true")
    p.add_argument("--train_split", type=str, default="train",
                   choices=["train", "trainval", "all"])
    p.add_argument("--test_split", type=str, default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--random_image_batch", action="store_true")
    p.add_argument("--enable_cam_near_far", action="store_true")
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--num_steps", type=int, nargs="*", default=[128, 64, 32])
    p.add_argument("--background", type=str, default="last_sample",
                   choices=["white", "random", "last_sample"])
    p.add_argument("--max_ray_batch", type=int, default=4096 * 4)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--adaptive_num_rays", action="store_true")
    p.add_argument("--num_points", type=int, default=2 ** 18)
    p.add_argument("--lambda_entropy", type=float, default=0)
    p.add_argument("--lambda_proposal", type=float, default=1)
    p.add_argument("--lambda_distort", type=float, default=0.02)
    p.add_argument("--lambda_distort_warmup", type=int, default=1000,
                   help="ramp lambda_distort in over [w, 2w] steps; 0 = "
                        "active from step 0")
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
    return Config(**kw).replace(bound=128.0, contract=True,
                                adaptive_num_rays=True)


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
    device = resolve_device(cfg.device)
    # the view MLP, SSIM and any plain twin stay true fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .data.provider import load_scene, split_indices
    from .models import make_field, params_from_jax
    from .train.metrics import PSNRMeter, SSIMMeter
    from .train.trainer import Trainer

    model = make_field(cfg.field_type, device=device, seed=cfg.seed,
                       grid_bound=cfg.grid_bound, cp_rank=cfg.cp_rank,
                       cp_res=cfg.cp_res, density_bias=cfg.density_bias)
    npz = cfg.ckpt.endswith(".npz")
    trainer = Trainer("ngp", cfg, model, cfg.workspace,
                      resume=cfg.ckpt == "latest")
    if npz:
        with np.load(cfg.ckpt) as f:
            trainer.state.load_weights(params_from_jax(dict(f)))
        trainer.log(f"[INFO] loaded JAX parameters from {cfg.ckpt}")
    elif not trainer.resumed:
        trainer.log(f"[INFO] no checkpoint: field initialised from --seed "
                    f"{cfg.seed}")

    scene = load_scene(cfg.path, cfg.data_type, cfg.downscale, cfg.scale,
                       cfg.offset, cfg.enable_cam_center, cfg.bound)
    n = scene.poses.shape[0]
    val_scene = _subset(scene, split_indices(n, cfg.test_split, cfg.val_type))
    if cfg.test:
        trainer.test(val_scene)
        return trainer
    train_scene = _subset(scene, split_indices(n, cfg.train_split,
                                               cfg.val_type))
    trainer.train(train_scene, val_scene)
    trainer.evaluate(val_scene, meters=[PSNRMeter(), SSIMMeter()],
                     save_dir=os.path.join(cfg.workspace, "validation"))
    return trainer
