"""Static configuration: the `Config` fields the stage-1 and stage-3 paths
read.

A copy of the matching fields of the JAX package's `Config` (defaults
unchanged, including the post-parse hard overrides bound=128,
contract=True and adaptive_num_rays=True, which `cli.config_from_args`
applies with fp16=False and preload=True), plus `device`.
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
    # stage-3 camera: fovy 60 at this square resolution, unless
    # use_default_intrinsics
    online_resolution: int = 512
    # parsed only: the reference forces fp16 off after parsing
    fp16: bool = False

    # testing
    save_cnt: int = 20
    eval_cnt: int = 5
    test: bool = False

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
    render_mask_type: str = "heatmap"  # mask | composition | heatmap
    render_mask_instance_id: int = 0
    # parsed only: in JAX it acts with --with_sam alone (stage 2, not
    # ported); --test --with_mask always writes the mask probabilities
    return_extra: bool = False

    # port: where tensors live ("cuda" unless the caller asks for "cpu")
    device: Optional[str] = None

    @property
    def grid_bound(self) -> float:
        """Bound used for grid queries: contraction maps the world into
        [-2, 2]^3."""
        return 2.0 if self.contract else self.bound

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
