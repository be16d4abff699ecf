"""CLI of the port: `python -m sanerf_hq_tpu_torch <scene> [flags]` trains
stage 1 of the hash-grid field (`--field_type hashgrid`, the default, or
`hashgrid_packed`) or of the flagship MLP field (`--field_type mlp`), then
evaluates PSNR and SSIM into `<workspace>/validation/`; with `--test` it
renders the held-out views into `<workspace>/results/{stem}_rgb.png` and
`{stem}_depth.npy`.  Scenes: `--data_type mip` (the default) and `lerf`
read a COLMAP model (`--downscale k` takes `images_k/`), `others`,
`llff` and `3dfront` (data/provider.py).

Stage 3, either field: `--with_mask --mask_root <masks>` trains the
object field, then evaluates mean IoU on the held-out views.  With
`--init_ckpt <stage-1 workspace>` the backbone is loaded from it and
frozen; the MLP field's mask step then renders it through the level
kernels (K5, K6), and the hash-grid field's (`m_grid`, mask_mlp) through
the composable route (K10), as in JAX.  Without it the backbone is
trainable (initialised from `--seed`) and the step renders through the
composable route (K8 on the MLP field, K10).  `--test --with_mask`
resumes it and writes `results/{stem}_mask.npy` and `{stem}_mask_vis.png`.
The mask directory holds the decode output: `{stem}_obj_mask.npy` ([1, H,
W] uint8 labels) and `valid_dict.json`.

The flags are the JAX CLI's that these paths read, plus `--device`;
`--fp16`, `--preload`, `--return_extra` and `--mixed_sampling` are parsed
only (the reference forces fp16 off and preload on after parsing, and
overrides --bound to 128 and --contract on).
`--ckpt latest` (the default) resumes the newest checkpoint in
`<workspace>/checkpoints`; `--ckpt` also takes an `.npz` of JAX parameters
(models/convert.py).  Otherwise the field is initialised from `--seed`
(and, with `--init_ckpt`, the backbone from the init checkpoint).
"""
from __future__ import annotations

import argparse
import copy
import json
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
                        "field parameters")
    p.add_argument("--fp16", action="store_true",
                   help="parsed only: forced off, as in the reference")
    p.add_argument("--init_ckpt", type=str, default="",
                   help="stage hand-off: a port workspace (its newest "
                        "checkpoint) or an .npz of JAX parameters; what it "
                        "holds is loaded and frozen")
    p.add_argument("--online_resolution", type=int, default=512)
    p.add_argument("--save_cnt", type=int, default=20)
    p.add_argument("--eval_cnt", type=int, default=5)
    p.add_argument("--test", action="store_true")
    p.add_argument("--train_split", type=str, default="train",
                   choices=["train", "trainval", "all"])
    p.add_argument("--test_split", type=str, default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--preload", action="store_true",
                   help="parsed only: scenes are always loaded whole")
    p.add_argument("--random_image_batch", action="store_true")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--bound", type=float, default=2,
                   help="parsed, then forced to 128 as in the reference")
    p.add_argument("--scale", type=float, default=-1)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--val_type", type=str, default="default",
                   choices=["default", "val_all", "val_split"])
    p.add_argument("--test_view_path", type=str, default=None)
    p.add_argument("--enable_cam_near_far", action="store_true")
    p.add_argument("--enable_cam_center", action="store_true")
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--num_steps", type=int, nargs="*", default=[128, 64, 32])
    p.add_argument("--contract", action="store_true",
                   help="parsed, then forced on as in the reference")
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
    p.add_argument("--lambda_tv", type=float, default=0)
    p.add_argument("--lambda_wd", type=float, default=0)
    p.add_argument("--data_type", type=str, default="mip",
                   choices=["mip", "lerf", "llff", "3dfront", "ctr", "pano",
                            "others"])
    p.add_argument("--field_type", type=str, default="hashgrid",
                   choices=["hashgrid", "hashgrid_packed", "mlp"])
    p.add_argument("--cp_rank", type=int, default=64)
    p.add_argument("--cp_res", type=int, default=256)
    p.add_argument("--density_bias", type=float, default=0.0)
    p.add_argument("--feat_rep", type=str, default="cp",
                   choices=["cp", "hashgrid"])
    p.add_argument("--feat_rank", type=int, default=128)
    p.add_argument("--feat_res", type=int, default=256)

    # stage 3: object field
    p.add_argument("--with_mask", action="store_true")
    p.add_argument("--mask_mlp_type", type=str, default="default",
                   choices=["default", "lightweight_mask"])
    p.add_argument("--mask_root", type=str, default=None)
    p.add_argument("--n_inst", type=int, default=2)
    p.add_argument("--label_regularization_weight", type=float, default=0.0)
    p.add_argument("--ray_pair_rgb_loss_weight", type=float, default=0)
    p.add_argument("--ray_pair_rgb_threshold", type=float, default=0.3)
    p.add_argument("--epsilon", type=float, default=1e-6)
    p.add_argument("--ray_pair_rgb_exp_weight", type=float, default=10)
    p.add_argument("--ray_pair_rgb_num_sample", type=int, default=1)
    p.add_argument("--ray_pair_rgb_iter", type=int, default=-1)
    p.add_argument("--ray_pair_rgb_use_pred_logistics", action="store_true")
    p.add_argument("--mixed_sampling", action="store_true",
                   help="parsed only: the local patches are always drawn")
    p.add_argument("--local_sample_patch_size", type=int, default=16)
    p.add_argument("--num_local_sample", type=int, default=2)
    p.add_argument("--error_map", action="store_true")
    p.add_argument("--error_map_size", type=int, default=128)
    p.add_argument("--use_default_intrinsics", action="store_true")
    p.add_argument("--render_mask_type", type=str, default="heatmap",
                   choices=["mask", "composition", "heatmap"])
    p.add_argument("--render_mask_instance_id", type=int, default=0)
    p.add_argument("--return_extra", action="store_true",
                   help="parsed only: acts with --with_sam (stage 2, not "
                        "ported); --test --with_mask always writes the mask "
                        "probabilities")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda (cpu must be asked for)")
    return p


def config_from_args(args) -> Config:
    kw = {k: v for k, v in vars(args).items()
          if k in Config.__dataclass_fields__}
    kw["num_steps"] = tuple(args.num_steps)
    kw["offset"] = tuple(args.offset)
    # post-parse hard overrides of the reference CLI
    return Config(**kw).replace(fp16=False, bound=128.0, preload=True,
                                contract=True, adaptive_num_rays=True)


def _subset(scene, idx):
    s = copy.copy(scene)
    s.images = scene.images[idx] if scene.images is not None else None
    s.poses = scene.poses[idx]
    s.intrinsics = (scene.intrinsics[idx] if scene.intrinsics.ndim == 2
                    else scene.intrinsics)
    s.img_names = scene.img_names[idx]
    if scene.cam_near_far is not None:
        s.cam_near_far = scene.cam_near_far[idx]
    if scene.masks is not None:
        s.masks = scene.masks[idx]
    return s


def load_init_params(path: str) -> dict:
    """--init_ckpt: an .npz of JAX parameters, or a port workspace (or its
    checkpoints/ directory), whose newest checkpoint's model weights are
    returned as a state_dict on the CPU."""
    from .models import params_from_jax
    from .train.checkpoints import CheckpointManager

    if path.endswith(".npz"):
        with np.load(path) as f:
            return params_from_jax(dict(f))
    ws = path.rstrip("/")
    if os.path.basename(ws) == "checkpoints":
        ws = os.path.dirname(ws)
    restored = CheckpointManager(ws).restore("cpu")
    if restored is None:
        raise FileNotFoundError(f"--init_ckpt {path}: no checkpoint in "
                                f"{os.path.join(ws, 'checkpoints')}")
    return restored["model"]


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    # fail fast, before any model or data is built
    if cfg.with_mask and not cfg.mask_root and not cfg.test:
        raise SystemExit("error: --with_mask training requires --mask_root "
                         "(decode outputs directory)")
    device = resolve_device(cfg.device)
    # the view MLP, SSIM and any plain twin stay true fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .data.provider import load_object_masks, load_scene, split_indices
    from .models import make_field, params_from_jax
    from .train import stages
    from .train.metrics import PSNRMeter, SSIMMeter
    from .train.trainer import Trainer

    model = make_field(cfg.field_type, device=device, seed=cfg.seed,
                       grid_bound=cfg.grid_bound, cp_rank=cfg.cp_rank,
                       cp_res=cfg.cp_res, density_bias=cfg.density_bias,
                       with_mask=cfg.with_mask, n_inst=cfg.n_inst,
                       mask_mlp_type=cfg.mask_mlp_type,
                       feat_rep=cfg.feat_rep, feat_rank=cfg.feat_rank,
                       feat_res=cfg.feat_res)
    scene = load_scene(cfg.path, cfg.data_type, cfg.downscale, cfg.scale,
                       cfg.offset, cfg.enable_cam_center, cfg.bound)
    test_view_names = None
    if cfg.test_view_path:
        with open(cfg.test_view_path) as f:
            test_view_names = json.load(f)
        if isinstance(test_view_names, dict):
            test_view_names = test_view_names.get(
                "test_view_list", test_view_names.get("test_views", []))
    mask_valid_idx = None
    if cfg.with_mask and cfg.mask_root:
        scene.masks, mask_valid_idx = load_object_masks(
            cfg.mask_root, scene.img_names, scene.H, scene.W, seed=cfg.seed)

    init_params = (load_init_params(cfg.init_ckpt)
                   if cfg.with_mask and cfg.init_ckpt else None)
    npz = cfg.ckpt.endswith(".npz")
    trainer = Trainer("ngp", cfg, model, cfg.workspace,
                      resume=cfg.ckpt == "latest", init_params=init_params)
    if npz:
        with np.load(cfg.ckpt) as f:
            trainer.state.load_weights(params_from_jax(dict(f)))
        trainer.log(f"[INFO] loaded JAX parameters from {cfg.ckpt}")
    elif not trainer.resumed and init_params is None:
        trainer.log(f"[INFO] no checkpoint: field initialised from --seed "
                    f"{cfg.seed}")

    n = scene.poses.shape[0]
    val_scene = _subset(scene, split_indices(
        n, cfg.test_split, cfg.val_type, test_view_names, scene.img_names))
    if cfg.test:
        if cfg.with_mask:
            stages.evaluate_masks(
                trainer, val_scene,
                save_dir=os.path.join(cfg.workspace, "results"),
                render_mask_type=cfg.render_mask_type)
        else:
            trainer.test(val_scene)
        return trainer
    train_idx = split_indices(n, cfg.train_split, cfg.val_type,
                              test_view_names, scene.img_names)
    if mask_valid_idx is not None:
        # stage 3 trains on the views with a valid mask only
        train_idx = train_idx[np.isin(train_idx, mask_valid_idx)]
    train_scene = _subset(scene, train_idx)
    if cfg.with_mask:
        stages.train_mask(trainer, train_scene)
        stages.evaluate_masks(trainer, val_scene)
        return trainer
    trainer.train(train_scene, val_scene)
    trainer.evaluate(val_scene, meters=[PSNRMeter(), SSIMMeter()],
                     save_dir=os.path.join(cfg.workspace, "validation"))
    return trainer
