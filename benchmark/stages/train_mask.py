"""Stage 3: the scripts' object-field job in the calls and order of
`stages.train_mask` (batch, mask step, the error-map rebuild every
`ray_pair_rgb_iter` steps, the metrics read every 20 steps), run back to
back: each job starts from step 0, a map of ones, the set-up copy of the
trained parameters, a fresh Adam and the job's seeded draws.  Set-up runs
one job on to its `later_step`: the rebuild on the way (the parameters it
rendered, the map it gave: `rebuild_check`) and three more checked steps
from the state the job reached there (`later_state`, their readings
`later`, with the map each step left).

The numbers compared: harness/check.py's training numbers of the job's
first three steps, and, where the reference can only start from the
program's own state (its parameters, Adam's moments, error map and draws
at the mix's `later_step`):
  later_*     the same numbers of the three steps from that state; each
              reference step after the first draws its batch from the map
              the program's step before it left, as a map that differs in
              round-off moves a drawn patch, and with the ray-pair loss on,
              a patch moved reads as a gap of 3e-3;
  later_map_gap  the widest |map - map_ref| over those steps and the cells
              of the map each left, the reference updating the map the
              program's step started from;
  map_gap     the widest |map - map_ref| over the cells of the error map
              the job rebuilt, the reference rendering the parameters the
              program's rebuild rendered."""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from benchmark.harness import check
from benchmark.harness.drivers import (CHECKED_STEPS, host, norms, span,
                                       sync)
from benchmark.reference import steps as ref_steps
from benchmark.stages import nerf

scene = nerf.scene
counts = nerf.counts


class Driver(nerf.NerfDriver):
    KEEP = nerf.NerfDriver.KEEP + ("readings", "gen_state", "rebuild_check",
                                   "later_state", "later")

    def setup(self):
        from sanerf_hq_tpu_torch.data.provider import resize_nearest
        from sanerf_hq_tpu_torch.data.sampler import fixed_fovy_intrinsics
        from sanerf_hq_tpu_torch.train.steps import make_mask_train_step

        self.rebuild_check = self.later_state = self.later = None
        self.build(trainable=self.tr["trainable"])
        tr, cfg, scene = self.trainer, self.prog.cfg, self.prog.train_scene
        self.mask_step = make_mask_train_step(
            tr.model, cfg, frozen_backbone=tr.backbone_frozen, shard=None)
        if self.fault == "half":
            inner = self.mask_step
            ng, nl = cfg.num_rays, cfg.num_local_sample * \
                cfg.local_sample_patch_size ** 2

            def half(state, batch, gen, error_map):
                keep = {k: v for k, v in batch.items()}
                for k in ("rays_o", "rays_d", "gt_masks"):
                    v = batch[k]
                    keep[k] = torch.cat([v[:ng // 2], v[ng:ng + nl]])
                keep["img_inds"] = batch["img_inds"][:ng // 2]
                keep["inds_coarse"] = batch["inds_coarse"][:ng // 2]
                old = cfg.num_rays
                object.__setattr__(cfg, "num_rays", ng // 2)
                try:
                    return inner(state, keep, gen, error_map)
                finally:
                    object.__setattr__(cfg, "num_rays", old)

            self.mask_step = half
        self.S = cfg.error_map_size
        if cfg.use_default_intrinsics:
            intr, self.H, self.W = scene.intrinsics[0], scene.H, scene.W
            masks = scene.masks
        else:
            self.H = self.W = cfg.online_resolution
            intr = fixed_fovy_intrinsics(cfg.online_resolution, 60.0)
            masks = np.stack([resize_nearest(m, self.H, self.W)
                              for m in scene.masks])
        self.masks_np, self.intr_np = scene.masks, intr
        dev = self.device
        self.masks_t = torch.as_tensor(masks, dtype=torch.long, device=dev)
        self.poses_t = torch.as_tensor(np.asarray(scene.poses, np.float32),
                                       device=dev)
        self.intr_t = torch.as_tensor(np.asarray(intr, np.float32),
                                      device=dev)
        self.rays_per_step = (cfg.num_rays + cfg.num_local_sample
                              * cfg.local_sample_patch_size ** 2)
        self.iters = cfg.iters
        self.trained0 = {n: p.detach().clone()
                         for n, p in self.prog.trained().items()}
        self.gen = torch.Generator(dev)
        self._start_job()
        tr.state.step = self.step = self.tr["check_step"]
        self.gen_state = self.gen.get_state().clone()
        self.readings = self._checked_steps()
        later = self.tr.get("later_step")
        if later is not None:
            if cfg.error_map and cfg.ray_pair_rgb_iter > 0 and any(
                    (later + i) % cfg.ray_pair_rgb_iter == 0
                    for i in range(1, CHECKED_STEPS + 1)):
                raise ValueError("a rebuild within the later checked steps: "
                                 "the reference follows their maps")
            while self.step < later:
                self._step(False, keep_rebuild=True)
            self.later_state = {
                "step0": tr.state.step, "map": self.error_map.detach().cpu(),
                "params": host(self.prog.trained()),
                "adam": self.prog.adam_state(),
                "gen": self.gen.get_state().clone()}
            self.later = self._checked_steps()
        # the job's course above warmed every shape the window runs
        self.mark("checked steps")
        self.rebuild_ms: List[float] = []
        self._start_job()
        sync(dev)
        self.mark("warm-up")

    @torch.no_grad()
    def _start_job(self):
        st = self.trainer.state
        for n, p in self.prog.trained().items():
            p.copy_(self.trained0[n])
        st.optimizer.state.clear()
        st.step = self.step = 0
        self.error_map = torch.ones((self.poses_t.shape[0], self.S * self.S),
                                    dtype=torch.float32, device=self.device)
        self.gen.manual_seed(self.prog.cfg.seed * 1000003 + st.step)

    def _checked_steps(self) -> dict:
        """Three steps on from where the job stands: their losses, the
        first step's gradient, the change by leaf and the map each step
        left."""
        p0 = {n: p.detach().clone() for n, p in self.prog.trained().items()}
        before = {n: m for n, (m, _, _) in self.prog.adam_state().items()}
        step0 = self.trainer.state.step
        losses, maps = [], []
        for i in range(CHECKED_STEPS):
            losses.append(float(self._step(False)["loss"]))
            maps.append(self.error_map.detach().cpu())
            if i == 0:
                grads = norms(self.prog.first_grads(before))
        changes = norms({n: p.detach() - p0[n]
                          for n, p in self.prog.trained().items()})
        return {"step0": step0, "losses": losses, "grads": grads,
                "changes": changes, "maps": maps}

    def _rebuild(self, tracing: bool):
        from sanerf_hq_tpu_torch.train.stages import update_error_map

        sync(self.device)
        t = time.perf_counter()
        with span(tracing, "update_error_map"):
            self.error_map = update_error_map(
                self.trainer, self.masks_np, self.prog.train_scene.poses,
                self.intr_np, self.H, self.W)
        if hasattr(self, "rebuild_ms"):
            self.rebuild_ms.append((time.perf_counter() - t) * 1e3)

    def _step(self, tracing: bool, keep_rebuild: bool = False):
        from sanerf_hq_tpu_torch.data.sampler import sample_mask_batch

        cfg, tr = self.prog.cfg, self.trainer
        with span(tracing, "sample_mask_batch"):
            batch = sample_mask_batch(
                self.gen, self.masks_t, self.poses_t, self.intr_t,
                self.error_map, cfg.num_rays, cfg.num_local_sample,
                cfg.local_sample_patch_size, self.H, self.W, self.S,
                use_error_map=cfg.error_map)
        with span(tracing, "mask_step"):
            metrics, self.error_map = self.mask_step(
                tr.state, batch, self.gen, self.error_map)
        self.step += 1
        if cfg.error_map and cfg.ray_pair_rgb_iter > 0 and \
                self.step % cfg.ray_pair_rgb_iter == 0:
            if keep_rebuild:
                self.rebuild_check = {"params": host(self.prog.trained())}
            self._rebuild(tracing)
            if keep_rebuild:
                self.rebuild_check["map"] = self.error_map.detach().cpu()
        if self.step == 1 or self.step % 20 == 0 or self.step == self.iters:
            metrics = {k: float(v) for k, v in metrics.items()}
        return metrics

    def window(self, seconds: float, tracing: bool = False,
               steps: Optional[int] = None) -> dict:
        n, t0 = 0, time.perf_counter()
        step_s, t = [], t0
        while (n < steps) if steps is not None else (
                t - t0 < seconds):
            if self.step >= self.iters:
                self._start_job()
            self._step(tracing)
            n += 1
            t, t_prev = time.perf_counter(), t
            step_s.append(t - t_prev)
        sync(self.device)
        dt = time.perf_counter() - t0
        return {"steps": n, "rays": n * self.rays_per_step, "seconds": dt,
                "rebuild_ms": list(self.rebuild_ms), "step_s": step_s}


def ref_config(cell) -> dict:
    out = nerf.ref_config(cell)
    flags = {**cell.config["flags"], **cell.traffic["flags"]}
    out.update(
        rays=int(flags["num_rays"]),
        num_local=int(flags["num_local_sample"]),
        patch=int(flags["local_sample_patch_size"]),
        H=int(flags["online_resolution"]),
        W=int(flags["online_resolution"]),
        error_map_size=int(flags["error_map_size"]),
        epsilon=float(flags["epsilon"]),
        exp_weight=float(flags["ray_pair_rgb_exp_weight"]),
        ray_pair_weight=float(flags["ray_pair_rgb_loss_weight"]),
        ray_pair_iter=int(flags["ray_pair_rgb_iter"]),
        ray_pair_threshold=float(flags["ray_pair_rgb_threshold"]),
        ray_pair_num_sample=int(flags["ray_pair_rgb_num_sample"]))
    return out


def stage_data(driver, rcfg):
    """The reference's views of the training set that show the object:
    (data for its steps, the labels and intrinsics of a rebuild)."""
    scene = driver.scene
    obj = driver.cell.config["scene"]["mask_object"]
    idx = np.asarray([i for i in nerf.train_views(scene)
                      if (scene["obj_ids"][i] == obj).sum() >= 10])
    labels = [(scene["obj_ids"][i] == obj).astype(np.int64) for i in idx]
    masks = np.stack([ref_steps.resize_nearest(m, rcfg["H"], rcfg["W"])
                      for m in labels])
    intr = ref_steps.fovy_intrinsics(rcfg["H"])
    dev = driver.device
    return ({"masks": torch.as_tensor(masks, device=dev),
             "poses": nerf.view_poses(driver, idx),
             "intr": torch.as_tensor(intr, device=dev)}, labels, intr)


def reference(driver, modes, later: bool = False, follow=None) -> dict:
    rcfg = ref_config(driver.cell)
    data, _, _ = stage_data(driver, rcfg)
    return nerf.train_reference(driver, rcfg, data, modes, later, follow)


def rebuild_reference(driver, modes) -> torch.Tensor:
    """The reference's rebuild of the error map from the parameters the
    program's rebuild rendered."""
    rcfg = ref_config(driver.cell)
    params, _ = nerf.params(driver, driver.rebuild_check["params"])
    field = ref_steps.make_field(rcfg, params, modes)
    data, labels, intr = stage_data(driver, rcfg)
    return ref_steps.rebuild_error_map(field, labels, data["poses"], intr,
                                       rcfg).cpu()


def numbers(driver, control: bool = False):
    prec = driver.cell.config["precision"]
    prog = reference(driver, prec["control"]) if control else driver.readings
    out = check.training_numbers(prog, reference(driver, prec["stated"]))
    if driver.later_state is not None:
        prog = (reference(driver, prec["control"], later=True) if control
                else driver.later)
        ref = reference(driver, prec["stated"], later=True,
                        follow=prog["maps"])
        later = check.training_numbers(prog, ref)
        out.update({"later_" + k: v for k, v in later.items()})
        out["later_map_gap"] = max(
            float((a.double() - b.double()).abs().max())
            for a, b in zip(prog["maps"], ref["maps"]))
    if driver.rebuild_check is not None:
        prog = (rebuild_reference(driver, prec["control"]) if control
                else driver.rebuild_check["map"])
        ref = rebuild_reference(driver, prec["stated"])
        out["map_gap"] = float((prog.double() - ref.double()).abs().max())
    return out
