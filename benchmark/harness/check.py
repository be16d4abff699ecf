"""How `correct` is decided: the reference (benchmark/reference) follows
what the timed path produced, from the inputs the benchmark made, and
each number compared is held to its limit from `benchmark/limits/`.

Training cells: the program's three checked steps (they go through the
window's own entry, at the step count the mix names) against the
reference's three steps from the same parameters, draws and views:
  loss_gap    the widest |loss - loss_ref| / |loss_ref| over the steps;
  grad_gap    over the trained leaves, |norm(g) - norm(g_ref)| / max(
              norm(g_ref), the median leaf's norm(g_ref)), g the first
              step's gradient as Adam holds it (exp_avg / (1 - b1));
  change_gap  the same of the parameters' change over the three steps,
              over the leaves whose reference gradient is at least a
              thousandth of the median leaf's (the others move under Adam
              by round-off alone);
  change_median  the median leaf's change gap: where the widest leaf's
              is the round-off of whichever leaf's later steps under
              Adam's eps of 1e-15, and swings from seed to seed, a cell
              compares this one (a step that leaves the state unchanged
              reads 1 either way).
Stage 3 also follows its job past the rebuild, where the reference can
only start from the program's own state (its parameters, Adam's moments,
error map and draws at the mix's `later_step`):
  later_*     the numbers above, of the three steps from that state;
              each reference step after the first draws its batch from
              the map the program's step before it left, as a map that
              differs in round-off moves a drawn patch, and with the
              ray-pair loss on, a patch moved reads as a gap of 3e-3;
  later_map_gap  the widest |map - map_ref| over those steps and the
              cells of the map each left, the reference updating the map
              the program's step started from;
  map_gap     the widest |map - map_ref| over the cells of the error map
              the job rebuilt, the reference rendering the parameters the
              program's rebuild rendered.
A cell compares the numbers its limits file names, each against its
limit.
Render cells: the answers the check sampled from the window, each view
against the reference's render of its pose:
  image_rmse  the widest RMS difference of a view's colours;
  depth_rel   the widest RMS difference of a view's depth over the
              reference's mean depth."""
from __future__ import annotations

import re
import statistics
from typing import Dict

import numpy as np
import torch

from ..reference import steps as ref_steps
from ..reference.common import Adam, Draws
from .scene import llff_poses

ADAM_B1 = Adam.B1


def ref_config(cell) -> dict:
    flags = {**cell.config["flags"], **cell.traffic["flags"]}
    field = cell.config["field"]
    out = {"field": field, "bound": float(flags["bound"]),
           "min_near": float(flags["min_near"]), "lr": float(flags["lr"]),
           "iters": int(flags["iters"]),
           "loss": {k: float(flags[k]) for k in
                    ("lambda_proposal", "lambda_distort",
                     "lambda_distort_warmup")},
           "chunk": int(flags.get("max_ray_batch", 16384))}
    if cell.traffic["stage"] == "train_mask":
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
    else:
        # the reference's adaptive ray count at its fixed point
        out["rays"] = int(flags["num_points"]) // field["num_steps"][-1]
    return out


def _scales(cell, names):
    rules = cell.config.get("lr_scales", [])
    out = {}
    for n in names:
        out[n] = next((float(s) for pat, s in rules if re.search(pat, n)),
                      1.0)
    return out


def _train_views(scene: dict, stage: str, mask_object: int):
    V = scene["images"].shape[0]
    idx = [i for i in range(V) if i % 16 != 0]
    if stage == "train_mask":
        idx = [i for i in idx
               if (scene["obj_ids"][i] == mask_object).sum() >= 10]
    return np.asarray(idx)


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.norm(v.detach().double()))
            for n, v in t.items()}


def _stage_data(driver, rcfg):
    """The reference's views of the training set, from the benchmark's
    scene: (data for its steps, the labels and intrinsics of a rebuild)."""
    cell, dev, scene = driver.cell, driver.device, driver.scene
    stage = cell.traffic["stage"]
    obj = cell.config["scene"]["mask_object"]
    idx = _train_views(scene, stage, obj)
    poses = torch.as_tensor(llff_poses(scene["poses"])[idx], device=dev)
    if stage == "train_rgb":
        return {"images": torch.as_tensor(
                    scene["images"][idx].astype(np.float32) / 255.0,
                    device=dev),
                "poses": poses,
                "intrinsics": torch.as_tensor(scene["intrinsics"],
                                              device=dev)}, None, None
    labels = [(scene["obj_ids"][i] == obj).astype(np.int64) for i in idx]
    masks = np.stack([ref_steps.resize_nearest(m, rcfg["H"], rcfg["W"])
                      for m in labels])
    intr = ref_steps.fovy_intrinsics(rcfg["H"])
    return ({"masks": torch.as_tensor(masks, device=dev), "poses": poses,
             "intr": torch.as_tensor(intr, device=dev)}, labels, intr)


def _params(driver, trained_from=None):
    """The benchmark's drawn parameters, the trained ones replaced by
    `trained_from` where given; the trained names."""
    pat = driver.cell.traffic.get("trainable")
    params = {n: v.detach().clone() for n, v in driver.params.items()}
    for n, v in (trained_from or {}).items():
        params[n] = v.to(driver.device).clone()
    trained = sorted(n for n in params if pat is None or re.search(pat, n))
    return params, trained


def train_reference(driver, modes: Dict[str, str], later: bool = False,
                    follow=None) -> dict:
    """The reference's three steps: from the drawn parameters, a fresh
    Adam and (stage 3) a map of ones at the program's first checked step;
    or, with `later`, from the state the program's job reached
    (`later_state`: parameters, Adam's moments, map, draws), each step
    after the first drawing from `follow`'s map of the step before where
    given.  Returns the losses, the first gradient's and the change's
    norms by leaf, and (stage 3) the map each step left."""
    cell, dev = driver.cell, driver.device
    rcfg = ref_config(cell)
    start = driver.later_state if later else None
    params, trained = _params(driver, start and start["params"])
    for n in trained:
        params[n].requires_grad_(True)
    field = ref_steps.make_field(rcfg, params, modes)
    step0 = (start or driver.readings)["step0"]
    opt = Adam({n: params[n] for n in trained}, _scales(cell, trained),
               rcfg["lr"], rcfg["iters"], t=step0)
    if start:
        opt.load({n: (m.to(dev), v.to(dev), k)
                  for n, (m, v, k) in start["adam"].items()})
    m0 = {n: opt.m[n].clone() for n in trained}
    draws = Draws(start["gen"] if start else driver.gen_state, dev)
    data, _, _ = _stage_data(driver, rcfg)
    if "masks" in data:
        error_map = (start["map"].to(dev) if start else torch.ones(
            (data["poses"].shape[0], rcfg["error_map_size"] ** 2),
            device=dev))
    p0 = {n: params[n].detach().clone() for n in trained}
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
            grads = _norms({n: (opt.m[n].double() - ADAM_B1 * m0[n].double())
                            / (1.0 - ADAM_B1) for n in trained})
    changes = _norms({n: params[n].detach() - p0[n] for n in trained})
    return {"losses": losses, "grads": grads, "changes": changes,
            "maps": maps}


def rebuild_reference(driver, modes: Dict[str, str]) -> torch.Tensor:
    """The reference's rebuild of the error map from the parameters the
    program's rebuild rendered."""
    rcfg = ref_config(driver.cell)
    params, _ = _params(driver, driver.rebuild_check["params"])
    field = ref_steps.make_field(rcfg, params, modes)
    data, labels, intr = _stage_data(driver, rcfg)
    return ref_steps.rebuild_error_map(field, labels, data["poses"], intr,
                                       rcfg).cpu()


def render_reference(driver, modes: Dict[str, str], keys) -> Dict[int, dict]:
    """The reference's render of each sampled view's pose."""
    cell, dev = driver.cell, driver.device
    rcfg = ref_config(cell)
    params = {n: v.detach().clone() for n, v in driver.params.items()}
    field = ref_steps.make_field(rcfg, params, modes)
    intr = torch.as_tensor(driver.intr, device=dev)
    out = {}
    for k in keys:
        pose = torch.as_tensor(driver.poses[k % len(driver.poses)],
                               device=dev)
        img, dep = ref_steps.render_view(field, pose, intr, driver.H,
                                         driver.W, rcfg, rcfg["chunk"])
        out[k] = {"image": img.cpu().numpy(), "depth": dep.cpu().numpy()}
    return out


def leaf_gaps(prog: dict, ref: dict):
    """Per leaf: the first gradient's gap, and the change's over the
    leaves that move."""
    g_ref = ref["grads"]
    med = statistics.median(g_ref.values())
    grads = {n: abs(prog["grads"].get(n, 0.0) - g) / max(g, med, 1e-30)
             for n, g in g_ref.items()}
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * med]
    c_ref = ref["changes"]
    medc = statistics.median(c_ref[n] for n in moved)
    changes = {n: abs(prog["changes"].get(n, 0.0) - c_ref[n])
               / max(c_ref[n], medc, 1e-30) for n in moved}
    return grads, changes


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if not all(np.isfinite(prog["losses"])):
        loss_gap = float("inf")
    grads, changes = leaf_gaps(prog, ref)
    return {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
            "change_gap": max(changes.values()),
            "change_median": statistics.median(changes.values())}


def render_numbers(prog: Dict[int, dict], ref: Dict[int, dict]):
    img = dep = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None:
            return {"image_rmse": float("inf"), "depth_rel": float("inf")}
        img = max(img, float(np.sqrt(np.mean((p["image"] - r["image"]) ** 2))))
        dep = max(dep, float(np.sqrt(np.mean((p["depth"] - r["depth"]) ** 2))
                             / max(np.mean(np.abs(r["depth"])), 1e-30)))
    return {"image_rmse": img, "depth_rel": dep}


def numbers(driver, control: bool = False) -> Dict[str, float]:
    """The numbers compared: the program's readings (with control, the
    reference's at the configuration's control precision in its place)
    against the reference's at the stated precision."""
    prec = driver.cell.config["precision"]
    if driver.cell.traffic["stage"] == "render":
        keys = sorted(driver.keep)
        prog = (render_reference(driver, prec["control"], keys) if control
                else driver.answers)
        return render_numbers(prog, render_reference(driver, prec["stated"],
                                                     keys))
    prog = (train_reference(driver, prec["control"]) if control
            else driver.readings)
    out = training_numbers(prog, train_reference(driver, prec["stated"]))
    if getattr(driver, "later_state", None) is not None:
        prog = (train_reference(driver, prec["control"], later=True)
                if control else driver.later)
        ref = train_reference(driver, prec["stated"], later=True,
                              follow=prog["maps"])
        later = training_numbers(prog, ref)
        out.update({"later_" + k: v for k, v in later.items()})
        out["later_map_gap"] = max(
            float((a.double() - b.double()).abs().max())
            for a, b in zip(prog["maps"], ref["maps"]))
    if getattr(driver, "rebuild_check", None) is not None:
        prog = (rebuild_reference(driver, prec["control"]) if control
                else driver.rebuild_check["map"])
        ref = rebuild_reference(driver, prec["stated"])
        out["map_gap"] = float((prog.double() - ref.double()).abs().max())
    return out
