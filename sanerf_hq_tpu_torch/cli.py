"""CLI of the port: `python -m sanerf_hq_tpu_torch <scene> [flags]` trains
stage 1 of the hash-grid field (`--field_type hashgrid`, the default, or
`hashgrid_packed`) or of the flagship MLP field (`--field_type mlp`), then
evaluates PSNR, SSIM and LPIPS (train/metrics.py `LPIPSMeter`: the VGG16
weights of `$SANERF_LPIPS_WEIGHTS`, else a seeded random proxy) into
`<workspace>/validation/`; with `--test` it
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

Stage 2 and decode (SAM, `--sam_type sam|sam_hq`, `--sam_model_type
vit_h|vit_l|vit_b`, `--sam_ckpt <released .pth>`; without the file SAM
gets random weights from `--seed`): `--with_sam --feature_container cache`
renders every view of the scene (val_all), encodes it with SAM's image
encoder and saves `<workspace>/sam_cache/{stem}.npy`; `--test --decode
--use_point --point_file <json>` renders each held-out view, projects the
3-D prompts with the depth gate, decodes them from the cached features and
writes `<workspace>/object_masks/` (`{stem}_rgb.png`, `_depth.npy`,
`_obj_mask.npy`, `valid_dict.json`), which `--mask_root` reads in stage 3.
`--init_ckpt` hands the stage-1 field to both.  `--with_sam
--feature_container distill` trains the field's SAM branch instead (the
CP volume `cp_s_*` or the table `s_grid`, then `samvit_mlp`; the backbone
frozen) for `--iters` steps on random training views at
`--online_resolution` (a ring of `--cache_size` encoded batches, the
encoder every `--cache_interval` steps once it is full), then prints the
rendered features' MSE (`[EVAL stage-2]`); `--test --decode
--feature_container distill` decodes from the rendered features, and
`--test --return_extra --with_sam` writes `results/{stem}_sam.npy`.

The viewer (`--gui`, the flags of scripts/gui.sh): a browser viewer of
the field on 127.0.0.1:7860 (render/web_viewer.py; frames of `--W` x
`--H` at fovy `--fovy`, an orbit camera at `--radius`), with right-click
point prompts that `S` saves as `<workspace>/picked_points.json` (the
`--point_file` the decode reads), keyframe recording and, without
`--test`, live training ticks on the training views.  Trajectory renders
into `<workspace>/trajectory/` (`{name}_rgb.png`, `_depth.npy`, and
`video.mp4` where imageio is installed): `--render_trajectory` (poses
interpolated along the training cameras, or a circle with `--camera_traj
circle`), `--test --circle`, and `--test --trajectory_root <dir>` (the
viewer's saved keyframes at 1024x1024).  `--vis_pose` writes the cameras
as `<workspace>/poses.ply` and goes on.  `--auto_seg` takes every view
with a decoded mask as valid and trains on all views.

Data parallelism: under `python -m torch.distributed.run --nproc_per_node
N -m sanerf_hq_tpu_torch ...` every rank trains on its slice of the rays
(NCCL on the cards; gloo with `--device cpu`) and rank 0 writes the
outputs; there is no flag for it, as JAX reads its device count.

The parser takes every flag of the JAX CLI, plus `--device`;
`--fp16`, `--preload`, `--mixed_sampling`, `--max_spp`, `--T_thresh`,
`--sum_after_mlp`, `--density_thresh`, `--ray_jittering`,
`--use_gt_focal_length`, `--scene_name`, `--object_name` and
`--val_save_root` are parsed only (the reference forces fp16 off and
preload on after parsing, and overrides --bound to 128 and --contract
on), and `--render_mesh` exits with an error, as in the JAX package.
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
from .parallel.mesh import init_process_group_from_env


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
    p.add_argument("--camera_traj", type=str, default="interp",
                   help="--render_trajectory poses: interp (along the "
                        "training cameras) or circle")
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
    p.add_argument("--T_thresh", type=float, default=1e-4,
                   help="surface parity only: dead in the reference too "
                        "(only read by the commented-out mesh branch, "
                        "nerf/renderer.py:386-498)")
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--num_steps", type=int, nargs="*", default=[128, 64, 32])
    p.add_argument("--contract", action="store_true",
                   help="parsed, then forced on as in the reference")
    p.add_argument("--background", type=str, default="last_sample",
                   choices=["white", "random", "last_sample"])
    p.add_argument("--max_ray_batch", type=int, default=4096 * 4)
    p.add_argument("--density_thresh", type=float, default=10,
                   help="surface parity only: dead in the reference too "
                        "(a torch-ngp occupancy-grid leftover; no "
                        "raymarching extension exists, SURVEY.md intro)")
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
    p.add_argument("--scene_name", type=str, default="garden",
                   help="parsed only, as in the JAX package")
    p.add_argument("--object_name", type=str, default="table_whole",
                   help="parsed only, as in the JAX package")
    p.add_argument("--field_type", type=str, default="hashgrid",
                   choices=["hashgrid", "hashgrid_packed", "mlp"])
    p.add_argument("--cp_rank", type=int, default=64)
    p.add_argument("--cp_res", type=int, default=256)
    p.add_argument("--density_bias", type=float, default=0.0)
    p.add_argument("--feat_rep", type=str, default="cp",
                   choices=["cp", "hashgrid"])
    p.add_argument("--feat_rank", type=int, default=128)
    p.add_argument("--feat_res", type=int, default=256)

    # stage 2 and decode: SAM
    p.add_argument("--with_sam", action="store_true")
    p.add_argument("--sam_type", type=str, default="sam",
                   choices=["sam", "sam_hq"])
    p.add_argument("--sam_model_type", type=str, default="vit_h",
                   choices=["vit_h", "vit_l", "vit_b"])
    p.add_argument("--sam_ckpt", type=str,
                   default="./pretrained/sam_vit_h_4b8939.pth",
                   help="a released SAM / HQ-SAM checkpoint; without the "
                        "file SAM gets random weights from --seed")
    p.add_argument("--feature_container", type=str, default="cache",
                   choices=["cache", "distill"])
    p.add_argument("--sam_use_view_direction", action="store_true",
                   help="the SAM MLP reads the composited view-dependent "
                        "features (the distill container)")
    p.add_argument("--sum_after_mlp", action="store_true",
                   help="surface parity only: dead in the reference too "
                        "(parsed at main.py:36; only read inside the "
                        "commented-out mesh branch, nerf/renderer.py:472)")
    p.add_argument("--cache_size", type=int, default=256,
                   help="the distill container's ring of encoded batches "
                        "(0: encode every step)")
    p.add_argument("--cache_interval", type=int, default=4,
                   help="once the ring is full, encode every this many "
                        "steps")
    p.add_argument("--on_device_sam", action="store_true", default=None,
                   dest="on_device_sam",
                   help="the distill container's ground truth rendered and "
                        "encoded on the device, the frame rounded to uint8 "
                        "levels and resized in float.  Default: on when "
                        "the device is CUDA (JAX: on its accelerator), off "
                        "on the CPU")
    p.add_argument("--no_on_device_sam", action="store_false",
                   dest="on_device_sam",
                   help="the ground truth through the host's uint8 image "
                        "(truncated) and OpenCV's uint8 resize, as the "
                        "reference")
    p.add_argument("--decode", action="store_true")
    p.add_argument("--point_file", type=str, default=None)
    p.add_argument("--use_point", action="store_true")

    # stage 3: object field
    p.add_argument("--with_mask", action="store_true")
    p.add_argument("--mask_mlp_type", type=str, default="default",
                   choices=["default", "lightweight_mask"])
    p.add_argument("--mask_root", type=str, default=None)
    p.add_argument("--n_inst", type=int, default=2)
    p.add_argument("--label_regularization_weight", type=float, default=0.0)
    p.add_argument("--ray_jittering", action="store_true",
                   help="surface parity only: dead in the reference too "
                        "(parsed at main.py:128, never read)")
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
    p.add_argument("--use_default_focal_length", action="store_true",
                   help="stage-2 eval: the view's focal length at "
                        "online_resolution instead of fovy 60")
    p.add_argument("--use_gt_focal_length", action="store_true",
                   help="surface parity only: dead in the reference too "
                        "(parsed at main.py:172, never read)")
    p.add_argument("--render_mesh", action="store_true",
                   help="refused, as in the JAX package: the reference's "
                        "mesh branch is commented out")
    p.add_argument("--val_save_root", type=str, default=None,
                   help="parsed only, as in the JAX package")
    p.add_argument("--auto_seg", action="store_true",
                   help="every view with a decoded mask is valid (no ::3 "
                        "subsampling); train on all views, validate on the "
                        "first 100")
    p.add_argument("--render_mask_type", type=str, default="heatmap",
                   choices=["mask", "composition", "heatmap"])
    p.add_argument("--render_mask_instance_id", type=int, default=0)
    p.add_argument("--return_extra", action="store_true",
                   help="--test --with_sam: also write each view's rendered "
                        "SAM features (results/{stem}_sam.npy); --test "
                        "--with_mask always writes the mask probabilities")

    # the viewer, trajectory renders and the pose dump
    p.add_argument("--vis_pose", action="store_true",
                   help="write the cameras, the bound and the sparse points "
                        "as <workspace>/poses.ply (and .png with "
                        "matplotlib), then go on")
    p.add_argument("--gui", action="store_true",
                   help="serve the browser viewer on 127.0.0.1:7860 (with "
                        "--test no training ticks)")
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--radius", type=float, default=0.5,
                   help="the viewer camera's orbit radius")
    p.add_argument("--fovy", type=float, default=60)
    p.add_argument("--max_spp", type=int, default=1,
                   help="parsed only, as in the JAX package (the page's spp "
                        "field sets the accumulation)")
    p.add_argument("--gui_mouse_right_drag", action="store_true",
                   help="right-drag pans; right-click picks no point")
    p.add_argument("--trajectory_root", type=str, default=None,
                   help="with --test: render the viewer's saved "
                        "trajectories (*.json here) at 1024x1024 into "
                        "<workspace>/trajectory")
    p.add_argument("--render_trajectory", action="store_true",
                   help="render poses synthesized from the training "
                        "cameras (--camera_traj) into <workspace>/trajectory")
    p.add_argument("--circle", action="store_true",
                   help="with --test: render a circle around the scene "
                        "into <workspace>/trajectory")
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


def _trajectory_scene(cfg: Config, scene, train_scene):
    """The poses of a trajectory render, without images: the viewer's
    saved keyframes under --trajectory_root (interpolated, 1024x1024 at
    fovy 60), else poses synthesized from the training cameras (a circle
    with --circle, else --camera_traj) with the scene's camera."""
    from .data.trajectory import (load_recorded_trajectories,
                                  synthesize_test_poses)

    t = copy.copy(scene)
    t.images = t.cam_near_far = t.masks = None
    if cfg.trajectory_root and os.path.isdir(cfg.trajectory_root):
        t.poses, t.intrinsics, t.img_names = load_recorded_trajectories(
            cfg.trajectory_root)
        t.H = t.W = int(2 * t.intrinsics[2])  # its square camera's size
    else:
        t.poses = synthesize_test_poses(
            train_scene.poses, "circle" if cfg.circle else cfg.camera_traj)
        t.intrinsics = (scene.intrinsics[0] if scene.intrinsics.ndim == 2
                        else scene.intrinsics)
        t.img_names = np.array([f"traj_{i:04d}" for i in range(len(t.poses))])
    return t


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
    if args.render_mesh:
        raise SystemExit(
            "error: --render_mesh is not supported (the reference's mesh "
            "branch is commented out / non-functional; see SURVEY.md §2.5)")
    cfg = config_from_args(args)
    # fail fast, before any model or data is built
    if cfg.decode and cfg.use_point and not cfg.point_file:
        raise SystemExit("error: --decode --use_point requires --point_file "
                         "(3-D prompt json, see example_points.json)")
    if cfg.decode and not cfg.with_sam:
        raise SystemExit("error: --decode requires --with_sam")
    if cfg.with_mask and not cfg.mask_root and not cfg.test:
        raise SystemExit("error: --with_mask training requires --mask_root "
                         "(decode outputs directory)")
    # under `python -m torch.distributed.run` this process joins the group
    # (NCCL on cuda:LOCAL_RANK, gloo with --device cpu) and trains on its
    # shard of the rays
    device = init_process_group_from_env(resolve_device(cfg.device))
    # the view MLP, SSIM and any plain twin stay true fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .data.provider import load_object_masks, load_scene, split_indices
    from .models import make_field, params_from_jax
    from .train import stages
    from .train import metrics as M
    from .train.trainer import Trainer

    model = make_field(cfg.field_type, device=device, seed=cfg.seed,
                       grid_bound=cfg.grid_bound, cp_rank=cfg.cp_rank,
                       cp_res=cfg.cp_res, density_bias=cfg.density_bias,
                       with_mask=cfg.with_mask, n_inst=cfg.n_inst,
                       mask_mlp_type=cfg.mask_mlp_type,
                       feat_rep=cfg.feat_rep, feat_rank=cfg.feat_rank,
                       feat_res=cfg.feat_res, with_sam=cfg.with_sam,
                       sam_use_view_direction=cfg.sam_use_view_direction)
    scene = load_scene(cfg.path, cfg.data_type, cfg.downscale, cfg.scale,
                       cfg.offset, cfg.enable_cam_center, cfg.bound)
    if cfg.vis_pose:
        from .utils.vis_pose import visualize_poses

        os.makedirs(cfg.workspace, exist_ok=True)
        ply = visualize_poses(
            scene.poses, bound=cfg.bound, points=scene.pts3d,
            out_path=os.path.join(cfg.workspace, "poses.ply"))
        print(f"[INFO] pose visualization written to {ply}(.png)")
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
            cfg.mask_root, scene.img_names, scene.H, scene.W, seed=cfg.seed,
            auto_seg=cfg.auto_seg)

    init_params = (load_init_params(cfg.init_ckpt)
                   if (cfg.with_sam or cfg.with_mask) and cfg.init_ckpt
                   else None)
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

    sam_predictor = None
    if cfg.with_sam:  # --decode requires it
        from .sam import SamPredictor, build_sam

        ckpt = cfg.sam_ckpt if os.path.exists(cfg.sam_ckpt) else None
        sam = build_sam(cfg.sam_model_type, checkpoint=ckpt,
                        hq=cfg.sam_type == "sam_hq", seed=cfg.seed,
                        device=device)
        sam_predictor = SamPredictor(sam)
        if ckpt is None:
            trainer.log(f"[WARN] SAM checkpoint {cfg.sam_ckpt} not found; "
                        f"using random weights from --seed {cfg.seed}")

    n = scene.poses.shape[0]
    train_idx = split_indices(n, cfg.train_split, cfg.val_type,
                              test_view_names, scene.img_names,
                              auto_seg=cfg.auto_seg)
    if mask_valid_idx is not None and not cfg.test:
        # stage 3 trains on the views with a valid mask only
        train_idx = train_idx[np.isin(train_idx, mask_valid_idx)]
    train_scene = _subset(scene, train_idx)
    # the cache holds every view
    val_type = ("val_all" if cfg.with_sam and cfg.feature_container ==
                "cache" else cfg.val_type)
    val_scene = _subset(scene, split_indices(
        n, cfg.test_split, val_type, test_view_names, scene.img_names,
        auto_seg=cfg.auto_seg))
    if cfg.render_trajectory or (cfg.test and cfg.camera_traj and
                                 (cfg.circle or cfg.trajectory_root)):
        trainer.test(_trajectory_scene(cfg, scene, train_scene),
                     save_dir=os.path.join(cfg.workspace, "trajectory"),
                     write_video=True)
        return trainer
    if cfg.gui:
        from .render.gui_api import InteractiveSession
        from .render.web_viewer import serve

        sess = InteractiveSession(
            trainer, scene=None if cfg.test else train_scene,
            W=cfg.W, H=cfg.H, fovy=cfg.fovy, radius=cfg.radius)
        serve(sess, points_path=os.path.join(cfg.workspace,
                                             "picked_points.json"),
              right_drag_pan=cfg.gui_mouse_right_drag)
        return trainer
    if cfg.test:
        if cfg.decode:
            from .utils.points import load_point_file

            stages.decode(trainer, val_scene, sam_predictor,
                          load_point_file(cfg.point_file),
                          feature_container=cfg.feature_container)
        elif cfg.with_mask:
            stages.evaluate_masks(
                trainer, val_scene,
                save_dir=os.path.join(cfg.workspace, "results"),
                render_mask_type=cfg.render_mask_type)
        else:
            trainer.test(val_scene, extra="sam" if cfg.return_extra
                         and cfg.with_sam else None)
        return trainer
    if cfg.with_sam and cfg.feature_container == "cache":
        stages.store_sam_features(trainer, val_scene, sam_predictor)
        return trainer
    if cfg.with_sam:
        on_device = (device.type == "cuda" if cfg.on_device_sam is None
                     else cfg.on_device_sam)
        stages.train_sam_distill(trainer, train_scene, sam_predictor,
                                 on_device=on_device)
        stages.evaluate_sam_features(trainer, val_scene, sam_predictor)
        return trainer
    if cfg.with_mask:
        stages.train_mask(trainer, train_scene)
        stages.evaluate_masks(trainer, val_scene)
        return trainer
    trainer.train(train_scene, val_scene)
    meters = [M.PSNRMeter(), M.SSIMMeter()]
    lp = M.LPIPSMeter(device=device)
    if lp.available:
        meters.append(lp)
    trainer.evaluate(val_scene, meters=meters,
                     save_dir=os.path.join(cfg.workspace, "validation"))
    return trainer
