"""A copy of the benchmark with tiny cells, for runs on the CPU: the
configurations' and mixes' shapes cut down (few views of few pixels, few
samples and rays), the widths the program fixes left as they are."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

SCENE = {"kind": "rich", "n_views": 4, "H": 24, "W": 32, "mask_object": 2}
STEPS = [16, 8, 4]
# each cell of BENCHMARK.json and its tiny stand-in
TINY = {"mlp-cp64.stage1-8k": "tiny-mlp.s1",
        "hashgrid.stage1-8k": "tiny-hash.s1",
        "hashgrid.stage3-obj": "tiny-hash.s3",
        "mlp-cp64.render-512": "tiny-mlp.r"}
LOOSE = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2,
         "map_gap": 1e-3, "image_rmse": 1e-3, "depth_rel": 1e-3}
LOOSE.update({"later_" + k: LOOSE[k] for k in ("loss_gap", "grad_gap",
                                               "change_gap", "map_gap")})


def _load(sub, name):
    with open(os.path.join(BENCH, sub, name + ".json")) as f:
        return json.load(f)


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(tmp: str) -> str:
    """A checkout-like directory under tmp with the benchmark and tiny
    cells tiny-mlp.s1, tiny-hash.s1, tiny-hash.s3, tiny-mlp.r; returns its
    root."""
    root = os.path.join(tmp, "checkout")
    bench = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    mlp = _load("configs", "mlp-cp64")
    mlp["field"].update(cp_rank=8, cp_res=32, num_steps=STEPS)
    mlp["scene"] = SCENE
    hg = _load("configs", "hashgrid")
    hg["field"]["num_steps"] = STEPS
    hg["scene"] = SCENE
    s1 = _load("traffic", "stage1-8k")
    s1["flags"].update(num_points=256)
    s1.update(warmup_steps=2, trace_steps=2)
    s3 = _load("traffic", "stage3-obj")
    s3["flags"].update(num_rays=64, local_sample_patch_size=4,
                       num_local_sample=2, iters=12, ray_pair_rgb_iter=4,
                       error_map_size=8, online_resolution=32,
                       max_ray_batch=512)
    s3.update(later_step=8, trace_steps=3)
    r = _load("traffic", "render-512")
    r["flags"].update(max_ray_batch=256)
    r.update(views={"H": 24, "W": 24, "fovy": 55.0, "orbit": 8},
             warmup_views=1, check={"views": 2, "within": 3}, trace_steps=2)
    files = {("configs", "tiny-mlp"): mlp, ("configs", "tiny-hash"): hg,
             ("traffic", "s1"): s1, ("traffic", "s3"): s3,
             ("traffic", "r"): r}
    for (sub, name), obj in files.items():
        _dump(os.path.join(bench, sub, name + ".json"), obj)
    cells = [("tiny-mlp", "s1"), ("tiny-hash", "s1"), ("tiny-hash", "s3"),
             ("tiny-mlp", "r")]
    for c, t in cells:
        keys = (("image_rmse", "depth_rel") if t == "r"
                else ("loss_gap", "grad_gap", "change_gap")
                + (("map_gap", "later_loss_gap", "later_grad_gap",
                    "later_change_gap", "later_map_gap") if t == "s3"
                   else ()))
        _dump(os.path.join(bench, "limits", f"{c}.{t}.json"),
              {k: LOOSE[k] for k in keys})
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"] = [
        {"name": n, "source": "tiny", "file": f"benchmark/configs/{n}.json",
         "reduced": [], "why": "tiny"} for n in ("tiny-mlp", "tiny-hash")]
    man["workloads"] = [{"name": f"{c}.{t}", "config": c, "traffic": t,
                         "chips": 1, "why": "tiny"} for c, t in cells]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY[w] for w in m["workloads"]]
    _dump(os.path.join(root, "BENCHMARK.json"), man)
    return root
