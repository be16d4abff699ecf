"""Static configuration: the `Config` fields the stage-1, stage-2 (the
feature cache and the distill container), decode, stage-3, viewer and
trajectory paths read.

A copy of the matching fields of the JAX package's `Config` (defaults
unchanged, including the post-parse hard overrides bound=128,
contract=True and adaptive_num_rays=True, which `cli.config_from_args`
applies with fp16=False and preload=True), plus `device` and
`on_device_sam` (a CLI flag the JAX package keeps outside its Config).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # paths / workspace
    path: str = ""
    workspace: str = "workspace"
    seed: int = 0
    # "latest": resume <workspace>/checkpoints; a .npz of JAX parameters
    # (models/convert.py); else a seeded init
    ckpt: str = "latest"
    # stage hand-off: a port workspace (its newest checkpoint) or an .npz of
    # JAX parameters; the parameters it holds are loaded and frozen
    init_ckpt: str = ""
    # stage 2 and decode: SAM (main.py:26-43 of the reference)
    with_sam: bool = False
    sam_type: str = "sam"  # sam | sam_hq
    sam_model_type: str = "vit_h"  # vit_h | vit_l | vit_b
    # a released checkpoint; without the file SAM gets random weights from
    # --seed
    sam_ckpt: str = "./pretrained/sam_vit_h_4b8939.pth"
    feature_container: str = "cache"  # cache | distill
    # the distill container: the SAM MLP reads the composited view-
    # dependent features; a ring of cache_size encoded batches, the encoder
    # run every cache_interval steps once it is full (0: every step)
    sam_use_view_direction: bool = False
    cache_size: int = 256
    cache_interval: int = 4
    # the distill container's ground truth: render and encode in one
    # device program (round(rgb * 255), the float bilinear resize) or
    # through the host's uint8 image (truncation, OpenCV's uint8 resize);
    # None: on when the device is CUDA
    on_device_sam: Optional[bool] = None
    # decode: --test --decode --use_point --point_file <json>
    decode: bool = False
    use_point: bool = False
    point_file: Optional[str] = None
    # stage-3 camera: fovy 60 at this square resolution, unless
    # use_default_intrinsics
    online_resolution: int = 512
    # parsed only: the reference forces fp16 off after parsing
    fp16: bool = False

    # testing
    save_cnt: int = 20
    eval_cnt: int = 5
    test: bool = False
    # --render_trajectory: interp (along the training cameras) | circle
    camera_traj: str = "interp"

    # dataset
    train_split: str = "train"
    test_split: str = "val"
    # parsed only: scenes are always loaded whole (forced on after parsing)
    preload: bool = False
    random_image_batch: bool = False
    val_type: str = "default"  # default | val_all | val_split
    test_view_path: Optional[str] = None
    downscale: int = 1
    bound: float = 128.0
    scale: float = -1.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    enable_cam_near_far: bool = False
    enable_cam_center: bool = False
    min_near: float = 0.2
    data_type: str = "mip"

    # training
    iters: int = 20000
    lr: float = 1e-2
    num_steps: Tuple[int, ...] = (128, 64, 32)
    contract: bool = True
    background: str = "last_sample"  # white | random | last_sample
    max_ray_batch: int = 4096 * 4
    num_rays: int = 4096
    adaptive_num_rays: bool = True  # forced: num_rays = num_points / T_final
    num_points: int = 2 ** 18

    # regularizers
    lambda_entropy: float = 0.0
    lambda_proposal: float = 1.0
    lambda_distort: float = 0.02
    # ramp lambda_distort in over [w, 2w] steps; 0 = active from step 0
    lambda_distort_warmup: int = 1000
    # total variation / weight decay of the hash-grid field's main table
    lambda_tv: float = 0.0
    lambda_wd: float = 0.0

    # field
    field_type: str = "hashgrid"
    cp_rank: int = 64
    cp_res: int = 256
    density_bias: float = 0.0
    # the MLP field's mask feature volume: "cp" or "hashgrid" (m_grid)
    feat_rep: str = "cp"
    feat_rank: int = 128
    feat_res: int = 256

    # stage 3: object field
    with_mask: bool = False
    mask_mlp_type: str = "default"  # default | lightweight_mask
    mask_root: Optional[str] = None
    n_inst: int = 2
    label_regularization_weight: float = 0.0
    ray_pair_rgb_loss_weight: float = 0.0
    ray_pair_rgb_threshold: float = 0.3
    epsilon: float = 1e-6
    ray_pair_rgb_exp_weight: float = 10.0
    ray_pair_rgb_num_sample: int = 1
    ray_pair_rgb_iter: int = -1
    ray_pair_rgb_use_pred_logistics: bool = False
    # parsed only: the sampler always draws the local patches, as the JAX
    # package's does
    mixed_sampling: bool = False
    local_sample_patch_size: int = 16
    num_local_sample: int = 2
    error_map: bool = False
    error_map_size: int = 128
    use_default_intrinsics: bool = False
    # stage-2 eval camera: the view's own focal length at
    # online_resolution instead of fovy 60
    use_default_focal_length: bool = False
    render_mask_type: str = "heatmap"  # mask | composition | heatmap
    render_mask_instance_id: int = 0
    # with --with_sam, --test also writes each view's rendered SAM features
    # ({stem}_sam.npy); --test --with_mask always writes the mask
    # probabilities
    return_extra: bool = False

    # every view with a decoded mask is valid (no ::3 subsampling, no
    # top-up); train on all views, validate on the first 100
    auto_seg: bool = False

    # the viewer (--gui): frame size, orbit radius and fovy of its camera;
    # right-drag pans instead of picking points
    gui: bool = False
    W: int = 512
    H: int = 512
    radius: float = 0.5
    fovy: float = 60.0
    gui_mouse_right_drag: bool = False
    # write the cameras, bound and sparse points as <workspace>/poses.ply
    vis_pose: bool = False

    # trajectory renders into <workspace>/trajectory: the viewer's saved
    # keyframes (trajectory_root) or poses synthesized from the training
    # cameras (render_trajectory; circle for an orbit)
    trajectory_root: Optional[str] = None
    render_trajectory: bool = False
    circle: bool = False

    # port: where tensors live ("cuda" unless the caller asks for "cpu")
    device: Optional[str] = None
    # the data-parallel mesh over the process group's ranks (-1: all of
    # them); rays are sharded over the "data" axis, parameters replicated
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)

    @property
    def grid_bound(self) -> float:
        """Bound used for grid queries: contraction maps the world into
        [-2, 2]^3."""
        return 2.0 if self.contract else self.bound

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
