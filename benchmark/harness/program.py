"""The program under test, built as its CLI builds it: the flags of the
configuration and the traffic mix go through the CLI's parser and
`config_from_args`, the field through `make_field`, the scene through the
loader and the split, and the Trainer over them.  Only the parameters are
replaced, by the benchmark's draws from the seed, before the Trainer
copies them into its EMA.  `field_flags`: the field's sizes the CLI
takes as flags, as the stage reads them from the configuration."""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from . import params as params_mod


def flags_argv(flags: dict) -> list:
    out = []
    for k, v in flags.items():
        if v is True:
            out.append(f"--{k}")
        elif v is False or v is None:
            continue
        elif isinstance(v, (list, tuple)):
            out += [f"--{k}", *map(str, v)]
        else:
            out += [f"--{k}", str(v)]
    return out


def subset(scene, idx):
    s = copy.copy(scene)
    s.images = scene.images[idx] if scene.images is not None else None
    s.poses = scene.poses[idx]
    s.intrinsics = (scene.intrinsics[idx] if scene.intrinsics.ndim == 2
                    else scene.intrinsics)
    s.img_names = scene.img_names[idx]
    if scene.masks is not None:
        s.masks = scene.masks[idx]
    return s


class Program:
    """cfg, model, trainer, the training scene (train_scene) and the
    benchmark's copy of the parameters it drew (params)."""

    def __init__(self, cell, scene_dir: str, workspace: str, seed: int,
                 device: torch.device, trainable: Optional[str] = None,
                 field_flags: Optional[dict] = None):
        from sanerf_hq_tpu_torch.cli import build_parser, config_from_args
        from sanerf_hq_tpu_torch.data.provider import (load_object_masks,
                                                       load_scene,
                                                       split_indices)
        from sanerf_hq_tpu_torch.models import make_field
        from sanerf_hq_tpu_torch.train.trainer import Trainer

        argv = [scene_dir, "--workspace", workspace, "--seed", str(seed),
                "--device", str(device.type),
                *flags_argv(cell.config["flags"]),
                *flags_argv(field_flags or {}),
                *flags_argv(cell.traffic["flags"])]
        if cell.traffic.get("masks"):
            argv += ["--mask_root", f"{scene_dir}/masks"]
        cfg = config_from_args(build_parser().parse_args(argv))
        # as the CLI: the fp32 parts stay fp32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = make_field(
            cfg.field_type, device=device, seed=cfg.seed,
            grid_bound=cfg.grid_bound, cp_rank=cfg.cp_rank,
            cp_res=cfg.cp_res, density_bias=cfg.density_bias,
            with_mask=cfg.with_mask, n_inst=cfg.n_inst,
            mask_mlp_type=cfg.mask_mlp_type, feat_rep=cfg.feat_rep,
            feat_rank=cfg.feat_rank, feat_res=cfg.feat_res,
            with_sam=cfg.with_sam,
            sam_use_view_direction=cfg.sam_use_view_direction)
        self.params: Dict[str, torch.Tensor] = params_mod.fill(
            model, cell.config["init"], seed, device)
        scene = load_scene(cfg.path, cfg.data_type, cfg.downscale, cfg.scale,
                           cfg.offset, cfg.enable_cam_center, cfg.bound)
        valid = None
        if cfg.with_mask:
            scene.masks, valid = load_object_masks(
                cfg.mask_root, scene.img_names, scene.H, scene.W,
                seed=cfg.seed, auto_seg=cfg.auto_seg)
        idx = split_indices(scene.poses.shape[0], cfg.train_split,
                            cfg.val_type, None, scene.img_names,
                            auto_seg=cfg.auto_seg)
        if valid is not None:
            idx = idx[np.isin(idx, valid)]
        self.train_idx = idx
        self.train_scene = subset(scene, idx)
        init = None
        if trainable is not None:
            # the stage hand-off: what is not trained comes from the init
            # checkpoint, loaded and frozen
            import re
            init = {n: v for n, v in self.params.items()
                    if not re.search(trainable, n)}
        self.trainer = Trainer("ngp", cfg, model, workspace, resume=False,
                               init_params=init)
        self.cfg = self.trainer.cfg
        self.model = model
        self.device = device

    def trained(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def first_grads(self, before=None) -> Dict[str, torch.Tensor]:
        """The gradient of the step just made as Adam holds it:
        (exp_avg - b1 * exp_avg before the step) / (1 - b1), in float64
        (zero where Adam holds none); `before` on the host, by name."""
        opt = self.trainer.state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        out = {}
        for n, p in self.trained().items():
            m = opt.state.get(p, {}).get("exp_avg")
            if m is None:
                out[n] = torch.zeros_like(p)
                continue
            m = m.double()
            if before and n in before:
                m = m - b1 * before[n].to(m.device, torch.float64)
            out[n] = m / (1.0 - b1)
        return out

    def adam_state(self) -> Dict[str, tuple]:
        """(exp_avg, exp_avg_sq, updates made) of each trained leaf that
        Adam holds, on the host."""
        opt = self.trainer.state.optimizer
        out = {}
        for n, p in self.trained().items():
            st = opt.state.get(p)
            if st and "exp_avg" in st:
                out[n] = (st["exp_avg"].detach().cpu().clone(),
                          st["exp_avg_sq"].detach().cpu().clone(),
                          int(st["step"]))
        return out

    def free(self):
        for k in ("trainer", "model"):
            setattr(self, k, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
