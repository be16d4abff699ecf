"""Stage 1: `Trainer.train_one_step` after `prepare_training`, the EMA
updated once an epoch (a training view a step) as `Trainer.train` does;
the step count runs on from the checked steps' `check_step` and is sent
back to `wrap[1]` on reaching `wrap[0]`.

The checked steps start at the mix's `check_step` from the drawn
parameters and a fresh Adam, at a step count of the window, where the
distortion loss has its full weight and the proposals learn; the
reference follows them from the same parameters, draws and views
(harness/check.py `training_numbers`)."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import check
from benchmark.harness.drivers import CHECKED_STEPS, norms, span, sync
from benchmark.stages import nerf

scene = nerf.scene
counts = nerf.counts


class Driver(nerf.NerfDriver):
    KEEP = nerf.NerfDriver.KEEP + ("readings", "gen_state")

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
                grads = norms(self.prog.first_grads())
        changes = norms({n: p.detach() - p0[n]
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
        step_s, t = [], t0
        while (n < steps) if steps is not None else (
                t - t0 < seconds):
            self._step(tracing)
            n += 1
            t, t_prev = time.perf_counter(), t
            step_s.append(t - t_prev)
        sync(self.device)
        dt = time.perf_counter() - t0
        return {"steps": n, "rays": n * self.rays_per_step, "seconds": dt,
                "step_s": step_s}


def ref_config(cell) -> dict:
    out = nerf.ref_config(cell)
    flags = {**cell.config["flags"], **cell.traffic["flags"]}
    # the reference's adaptive ray count at its fixed point
    out["rays"] = int(flags["num_points"]) // out["field"]["num_steps"][-1]
    return out


def stage_data(driver) -> dict:
    """The reference's views of the training set, from the benchmark's
    scene."""
    idx = nerf.train_views(driver.scene)
    return {"images": torch.as_tensor(
                driver.scene["images"][idx].astype(np.float32) / 255.0,
                device=driver.device),
            "poses": nerf.view_poses(driver, idx),
            "intrinsics": torch.as_tensor(driver.scene["intrinsics"],
                                          device=driver.device)}


def reference(driver, modes) -> dict:
    return nerf.train_reference(driver, ref_config(driver.cell),
                                stage_data(driver), modes)


def numbers(driver, control: bool = False):
    prec = driver.cell.config["precision"]
    prog = reference(driver, prec["control"]) if control else driver.readings
    return check.training_numbers(prog, reference(driver, prec["stated"]))
