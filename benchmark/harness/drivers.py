"""The general drivers a traffic mix picks by its `stage`:

  - `train_rgb`: stage 1 through `Trainer.train_one_step` after
    `prepare_training`, the EMA updated once an epoch (a training view a
    step) as `Trainer.train` does; the step count runs on from the checked
    steps' `check_step` and is sent back to `wrap[1]` on reaching
    `wrap[0]`;
  - `train_mask`: stage 3's job in the calls and order of
    `stages.train_mask` (batch, mask step, the error-map rebuild every
    `ray_pair_rgb_iter` steps, the metrics read every 20 steps), run back
    to back: each job starts from step 0, a map of ones, the set-up copy
    of the trained parameters, a fresh Adam and the job's seeded draws.
    Set-up runs one job on to its `later_step`: the rebuild on the way
    (the parameters it rendered, the map it gave: `rebuild_check`) and
    three more checked steps from the state the job reached there
    (`later_state`, their readings `later`, with the map each step left);
  - `render`: a closed loop of `Trainer.render_view` calls on poses along
    an orbit drawn from the seed.

Each driver builds the program, runs the steps the reference follows
(or keeps the answers the check samples), warms every shape of the cell,
and then runs its window; the checked steps' readings (`readings`) or
the sampled answers (`answers`) are what the check reads.  A training
mix's checked steps start at its `check_step` from the drawn parameters
and a fresh Adam: in stage 1 at a step count of its window, where the
distortion loss has its full weight and the proposals learn; in stage 3
at the job's start, and again past its rebuild (above)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .program import Program
from .scene import llff_poses, look_at_pose

CHECKED_STEPS = 3


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(tracing: bool, name: str):
    if not tracing:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.norm(t.detach().double()))
            for n, t in tensors.items()}


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu().clone() for n, t in tensors.items()}


class Driver:
    """Set-up, window and readings of one cell in one process."""

    def __init__(self, cell, seed: int, device: torch.device, workdir: str,
                 scene: dict, fault: Optional[str] = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.workdir, self.scene, self.fault = workdir, scene, fault
        self.tr = cell.traffic
        self.readings: dict = {}
        self.rebuild_check = self.later_state = self.later = None
        self.phases: Dict[str, float] = {}
        self._t = self._t0 = time.time()

    def mark(self, phase: str):
        """Close a phase of the set-up (its seconds go to stderr)."""
        now = time.time()
        self.phases[phase] = round(now - self._t, 3)
        self._t = now

    def build(self, trainable: Optional[str] = None):
        self.prog = Program(self.cell, os.path.join(self.workdir, "scene"),
                            os.path.join(self.workdir, "workspace"),
                            self.seed, self.device, trainable)
        self.trainer = self.prog.trainer
        self.mark("build")
        if self.fault == "frozen":
            st = self.trainer.state

            def unchanged():
                st.optimizer.zero_grad(set_to_none=True)
                st.step += 1

            st.apply_gradients = unchanged

    # what the check reads once the program's state is gone
    KEEP = ("cell", "seed", "device", "workdir", "scene", "fault", "tr",
            "phases",
            "readings", "params", "gen_state", "answers", "keep",
            "poses", "intr", "H", "W", "rebuild_check", "later_state",
            "later")

    def free(self):
        self.params = self.prog.params
        self.prog.free()
        for k in list(vars(self)):
            if k not in self.KEEP:
                delattr(self, k)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class TrainRGB(Driver):
    def setup(self):
        self.build()
        tr = self.trainer
        if self.fault == "half":
            inner = tr.train_step

            def half(state, batch, gen=None):
                n = batch["rays_o"].shape[0] // 2
                return inner(state, {k: v[:n] for k, v in batch.items()}, gen)

            tr.train_step = half
        tr.prepare_training(self.prog.train_scene)
        self.rays_per_step = tr.cfg.num_rays
        self.epoch = self.prog.train_scene.poses.shape[0]
        tr.state.step = step0 = self.tr["check_step"]
        self.gen_state = tr._train_data["gen"].get_state().clone()
        p0 = {n: p.detach().clone() for n, p in self.prog.trained().items()}
        losses = []
        for i in range(CHECKED_STEPS):
            losses.append(float(tr.train_one_step()["loss"]))
            if i == 0:
                grads = _norms(self.prog.first_grads())
        changes = _norms({n: p.detach() - p0[n]
                          for n, p in self.prog.trained().items()})
        self.readings = {"step0": step0, "losses": losses, "grads": grads,
                         "changes": changes}
        self.mark("checked steps")
        self.since_ema = CHECKED_STEPS
        for _ in range(self.tr["warmup_steps"]):
            self._step(False)
        sync(self.device)
        self.mark("warm-up")

    def _step(self, tracing):
        tr = self.trainer
        with span(tracing, "train_one_step"):
            tr.train_one_step()
        self.since_ema += 1
        if self.since_ema == self.epoch:
            with span(tracing, "update_ema"):
                tr.state.update_ema()
            self.since_ema = 0
        wrap = self.tr.get("wrap")
        if wrap and tr.state.step >= wrap[0]:
            tr.state.step = wrap[1]

    def window(self, seconds: float, tracing: bool = False,
               steps: Optional[int] = None) -> dict:
        n, t0 = 0, time.perf_counter()
        while (n < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            self._step(tracing)
            n += 1
        sync(self.device)
        dt = time.perf_counter() - t0
        return {"steps": n, "rays": n * self.rays_per_step, "seconds": dt}


class TrainMask(Driver):
    def setup(self):
        from sanerf_hq_tpu_torch.data.provider import resize_nearest
        from sanerf_hq_tpu_torch.data.sampler import fixed_fovy_intrinsics
        from sanerf_hq_tpu_torch.train.steps import make_mask_train_step

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
                "params": _host(self.prog.trained()),
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
                grads = _norms(self.prog.first_grads(before))
        changes = _norms({n: p.detach() - p0[n]
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
                self.rebuild_check = {"params": _host(self.prog.trained())}
            self._rebuild(tracing)
            if keep_rebuild:
                self.rebuild_check["map"] = self.error_map.detach().cpu()
        if self.step == 1 or self.step % 20 == 0 or self.step == self.iters:
            metrics = {k: float(v) for k, v in metrics.items()}
        return metrics

    def window(self, seconds: float, tracing: bool = False,
               steps: Optional[int] = None) -> dict:
        n, t0 = 0, time.perf_counter()
        while (n < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            if self.step >= self.iters:
                self._start_job()
            self._step(tracing)
            n += 1
        sync(self.device)
        dt = time.perf_counter() - t0
        return {"steps": n, "rays": n * self.rays_per_step, "seconds": dt,
                "rebuild_ms": list(self.rebuild_ms)}


def orbit_poses(poses: np.ndarray, n: int, rng: np.random.Generator,
                elevation=(0.25, 0.6)) -> np.ndarray:
    """n poses on a circle around the point the cameras look at, at their
    mean distance, the start angle and the elevation drawn from rng."""
    o = poses[:, :3, 3].astype(np.float64)
    d = -poses[:, :3, 2].astype(np.float64)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    A = sum(np.eye(3) - np.outer(v, v) for v in d)
    b = sum((np.eye(3) - np.outer(v, v)) @ p for v, p in zip(d, o))
    c = np.linalg.solve(A, b)
    up = poses[:, :3, 1].mean(0).astype(np.float64)
    up /= np.linalg.norm(up)
    e1 = np.cross(up, [1.0, 0.0, 0.0])
    if np.linalg.norm(e1) < 1e-3:
        e1 = np.cross(up, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(up, e1)
    r = np.linalg.norm(o - c, axis=-1).mean()
    th0 = rng.uniform(0, 2 * np.pi)
    phi = rng.uniform(*elevation)
    out = []
    for k in range(n):
        th = th0 + 2 * np.pi * k / n
        eye = c + r * (np.cos(phi) * (np.cos(th) * e1 + np.sin(th) * e2)
                       + np.sin(phi) * up)
        out.append(look_at_pose(eye, c, up))
    return np.stack(out).astype(np.float32)


class Render(Driver):
    def setup(self):
        self.build()
        v = self.tr["views"]
        self.H, self.W = v["H"], v["W"]
        focal = 0.5 * self.H / np.tan(0.5 * np.deg2rad(v["fovy"]))
        self.intr = np.array([focal, focal, self.W / 2, self.H / 2],
                             np.float32)
        rng = np.random.default_rng(self.seed)
        self.poses = orbit_poses(llff_poses(self.scene["poses"]),
                                 v["orbit"], rng)
        within = self.tr["check"]["within"]
        self.keep = set(int(i) for i in rng.choice(
            within, self.tr["check"]["views"], replace=False))
        self.answers: Dict[int, dict] = {}
        self.k = 0
        for i in range(self.tr["warmup_views"]):
            self.trainer.render_view(self.poses[-1 - i], self.intr, self.H,
                                     self.W)
        sync(self.device)
        self.mark("warm-up")

    def _view(self, tracing: bool):
        k = self.k
        with span(tracing, "render_view"):
            out = self.trainer.render_view(self.poses[k % len(self.poses)],
                                           self.intr, self.H, self.W)
        if self.fault == "half":
            out["image"][out["image"].shape[0] // 2:] = 0.0
        elif self.fault == "altered":
            out["image"] = out["image"] + 0.02
        if k in self.keep:
            self.answers[k] = {"image": out["image"], "depth": out["depth"]}
        self.k += 1

    def window(self, seconds: float, tracing: bool = False,
               steps: Optional[int] = None) -> dict:
        lat, t0 = [], time.perf_counter()
        while (len(lat) < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            t = time.perf_counter()
            self._view(tracing)
            lat.append(time.perf_counter() - t)
        dt = time.perf_counter() - t0
        # the client asks on, uncounted, for sampled views a short window
        # did not reach
        while self.k <= max(self.keep):
            self._view(False)
        return {"views": len(lat), "rays": len(lat) * self.H * self.W,
                "seconds": dt, "latency_s": lat, "steps": len(lat)}


DRIVERS = {"train_rgb": TrainRGB, "train_mask": TrainMask, "render": Render}
