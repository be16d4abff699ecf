"""What the NeRF stages (train_rgb, train_mask, render) share; not a stage
itself: the program built through the port's CLI over the benchmark's
scene, the work counts of the configuration's field, the reference's
settings, and its three training steps from the state the program's
checked steps started at."""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness.counts import counts_for
from benchmark.harness.drivers import Driver, norms
from benchmark.harness.program import Program
from benchmark.harness.scene import llff_poses, write_scene
from benchmark.reference import steps as ref_steps
from benchmark.reference.common import Adam, Draws


def scene(workdir: str, cell) -> dict:
    """The configuration's scene, written where the program loads it."""
    return write_scene(os.path.join(workdir, "scene"), cell.config["scene"])


def counts(cell):
    return counts_for(cell.config["field"])


class NerfDriver(Driver):
    def build(self, trainable: Optional[str] = None):
        cfg = self.cell.config
        self.prog = Program(
            self.cell, os.path.join(self.workdir, "scene"),
            os.path.join(self.workdir, "workspace"), self.seed, self.device,
            trainable, {k: cfg["field"][k] for k in cfg.get("field_flags",
                                                            [])})
        self.trainer = self.prog.trainer
        self.mark("build")
        if self.fault == "frozen":
            st = self.trainer.state

            def unchanged():
                st.optimizer.zero_grad(set_to_none=True)
                st.step += 1

            st.apply_gradients = unchanged


def ref_config(cell) -> dict:
    """The reference's settings every NeRF stage reads, from the flags of
    the configuration and the mix; a stage adds its own."""
    flags = {**cell.config["flags"], **cell.traffic["flags"]}
    return {"field": cell.config["field"], "bound": float(flags["bound"]),
            "min_near": float(flags["min_near"]), "lr": float(flags["lr"]),
            "iters": int(flags["iters"]),
            "loss": {k: float(flags[k]) for k in
                     ("lambda_proposal", "lambda_distort",
                      "lambda_distort_warmup")},
            "chunk": int(flags.get("max_ray_batch", 16384))}


def train_views(scene: dict) -> np.ndarray:
    """The program's training split of the scene: every view but each
    sixteenth."""
    return np.asarray([i for i in range(scene["images"].shape[0])
                       if i % 16 != 0])


def view_poses(driver, idx) -> torch.Tensor:
    return torch.as_tensor(llff_poses(driver.scene["poses"])[idx],
                           device=driver.device)


def _scales(cell, names):
    rules = cell.config.get("lr_scales", [])
    out = {}
    for n in names:
        out[n] = next((float(s) for pat, s in rules if re.search(pat, n)),
                      1.0)
    return out


def params(driver, trained_from=None):
    """The benchmark's drawn parameters, the trained ones replaced by
    `trained_from` where given; the trained names."""
    pat = driver.cell.traffic.get("trainable")
    out = {n: v.detach().clone() for n, v in driver.params.items()}
    for n, v in (trained_from or {}).items():
        out[n] = v.to(driver.device).clone()
    trained = sorted(n for n in out if pat is None or re.search(pat, n))
    return out, trained


def train_reference(driver, rcfg: dict, data: dict, modes: Dict[str, str],
                    later: bool = False, follow=None) -> dict:
    """The reference's three steps over the stage's `data`: from the drawn
    parameters, a fresh Adam and (stage 3: `data` holds masks) a map of
    ones at the program's first checked step; or, with `later`, from the
    state the program's job reached (`later_state`: parameters, Adam's
    moments, map, draws), each step after the first drawing from
    `follow`'s map of the step before where given.  Returns the losses,
    the first gradient's and the change's norms by leaf, and (stage 3)
    the map each step left."""
    cell, dev = driver.cell, driver.device
    start = driver.later_state if later else None
    ps, trained = params(driver, start and start["params"])
    for n in trained:
        ps[n].requires_grad_(True)
    field = ref_steps.make_field(rcfg, ps, modes)
    step0 = (start or driver.readings)["step0"]
    opt = Adam({n: ps[n] for n in trained}, _scales(cell, trained),
               rcfg["lr"], rcfg["iters"], t=step0)
    if start:
        opt.load({n: (m.to(dev), v.to(dev), k)
                  for n, (m, v, k) in start["adam"].items()})
    m0 = {n: opt.m[n].clone() for n in trained}
    draws = Draws(start["gen"] if start else driver.gen_state, dev)
    if "masks" in data:
        error_map = (start["map"].to(dev) if start else torch.ones(
            (data["poses"].shape[0], rcfg["error_map_size"] ** 2),
            device=dev))
    p0 = {n: ps[n].detach().clone() for n in trained}
    losses, grads, maps = [], None, []
    for step in range(step0, step0 + 3):
        if "masks" in data:
            if follow is not None and step > step0:
                error_map = follow[step - step0 - 1].to(dev)
            loss, error_map = ref_steps.mask_step(field, opt, draws, data,
                                                  error_map, rcfg, step)
            maps.append(error_map.cpu())
        else:
            loss = ref_steps.rgb_step(field, opt, draws, data, rcfg, step)
        losses.append(loss)
        if step == step0:
            grads = norms({n: (opt.m[n].double() - Adam.B1 * m0[n].double())
                           / (1.0 - Adam.B1) for n in trained})
    changes = norms({n: ps[n].detach() - p0[n] for n in trained})
    return {"losses": losses, "grads": grads, "changes": changes,
            "maps": maps}
