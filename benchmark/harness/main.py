"""One run of one cell: set-up, the measured window, with --trace 1 the
traced slice, the check, and one JSON line on stdout.

The cell's name resolves to its files (manifest.py): its traffic mix's
`stage` to the stage's module in benchmark/stages/ (its driver, its
numbers of the check, its work counts, its scene), every metric to its
reader in benchmark/metrics/."""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import check, guard, manifest
from .hoststats import HostStats
from .trace import profile


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="put the reference at the configuration's control "
                        "precision in the program's place (a check that "
                        "must come out not correct)")
    p.add_argument("--fault", choices=("frozen", "half", "altered"),
                   help="break the timed path (a check that must come out "
                        "not correct)")
    return p.parse_args(argv)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": _power_limit()}


def run(args, cell, device, workdir: str, t0: float) -> int:
    stage = cell.stage_module()
    t_scene = time.time()
    scene = (stage.scene(workdir, cell) if hasattr(stage, "scene")
             else None)
    driver = stage.Driver(cell, args.seed, device, workdir, scene,
                          args.fault)
    driver.setup()
    setup_s = time.time() - t0
    phases = {"start": round(t_scene - t0, 3),
              "scene": round(driver._t0 - t_scene, 3), **driver.phases}
    print("setup phases (s): " + ", ".join(f"{k} {v}" for k, v in
                                            phases.items()), file=sys.stderr)
    stats = HostStats()
    stats.start()
    win = driver.window(args.seconds)
    print("host stats: " + json.dumps(stats.stop(win)), file=sys.stderr)
    rec = {"cell": cell, "setup_s": setup_s, "window": win,
           "counts": stage.counts(cell) if hasattr(stage, "counts")
           else None, "trace": None,
           "traced": None, "probes": {}, "driver": driver}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    readers = {m["name"]: cell.metric_module(m["name"]) for m in wanted}
    hooks = None
    if args.trace:
        rec["traced"], rec["trace"] = profile(
            lambda: driver.window(0, tracing=True,
                                  steps=cell.traffic["trace_steps"]),
            workdir, device)
        # probes watch one untraced step of their own, after the slice
        hooks = SimpleNamespace(driver=driver, probes=rec["probes"],
                                after=[])
        for mod in readers.values():
            if hasattr(mod, "install"):
                mod.install(hooks)
        if hooks.after:
            driver.window(0, steps=1)
        for fn in hooks.after:
            fn()
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = _device_info(device, cell.chips)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in the measured process: {bad}",
              file=sys.stderr)
        return 4
    trace = rec["trace"]
    rec = readers = hooks = None  # the program's state goes before the check
    driver.free()
    limits = cell.limits
    nums, over = check.judge(stage.numbers(driver, control=args.control),
                             limits)
    out = {"correct": not over,
           "attempted": int(win["steps"]),
           "failed": len(over),
           "metrics": metrics,
           "device": dev_info}
    if trace is not None:
        out["device"].update(busy_s=trace["busy_s"],
                             window_s=trace["window_s"])
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    out["check"] = {k: {"value": v, "limit": limits[k]}
                    for k, v in nums.items()}
    for k, v in nums.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def main(argv, t0: float, device=None, root=None, bench_dir=None) -> int:
    args = parse(argv)
    root = root or manifest.root_of()
    cell = manifest.cell(root, args.workload, bench_dir)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        return run(args, cell, device, workdir, t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
