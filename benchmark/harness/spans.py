"""The program's own spans and sync counter (`sanerf_hq_tpu_torch.utils.
profiling`), read over a slice of the cell's work after the traced slice.

Readers call `install(hooks)` from their own `install`; the first call of
a run registers one callback, however many readers ask.  The callback
runs the traffic's `trace_steps` steps (or views, as the cell counts) through
the cell's `window` with the tracer on, puts the tracer's snapshot in
`hooks.probes["spans"]`, with the slice's steps and seconds under
`window`, turns the tracer off and prints the slice's time a step and
the span table to stderr.  The profiled slice runs before it with the
tracer off, so that slice's device numbers keep their meaning.

`profiled_kernel_ms` reads the same spans from a `torch.profiler` trace
instead, where they are `record_function` ranges: the device time of the
kernels launched inside them, without the idle between.

A program without the tracer (an earlier commit) registers nothing, and
the readers stay silent; so they do on the CPU, where the tracer times
nothing on the device and counts no sync."""
from __future__ import annotations

import bisect
import json
import os
import statistics
import sys

from .trace import SPAN_CAT, _union

KEY = "spans"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def install(hooks):
    if KEY in hooks.probes:
        return
    hooks.probes[KEY] = None
    try:
        from sanerf_hq_tpu_torch.utils import profiling
    except ImportError:
        return
    if not all(hasattr(profiling, f) for f in ("enable", "snapshot",
                                               "disable")):
        return
    driver = hooks.driver
    steps = int(driver.cell.traffic["trace_steps"])

    def run():
        profiling.enable()
        try:
            on = driver.window(0, steps=steps)
            snap = profiling.snapshot()
        finally:
            profiling.disable()
        snap["window"] = {"steps": on["steps"], "seconds": on["seconds"]}
        hooks.probes[KEY] = snap
        print(f"spans slice: {on['steps']} steps, {on['seconds']:.4f} s, "
              f"{on['seconds'] / max(on['steps'], 1) * 1e3:.3f} ms a step "
              f"with the tracer on", file=sys.stderr)
        table = {p: [s["calls"], round(s["host_ms"], 3),
                     round(s["self_ms"], 3),
                     None if s["device_ms"] is None
                     else round(s["device_ms"], 3), s["syncs"]]
                 for p, s in snap["spans"].items()}
        print("spans (calls, host ms, self ms, device ms, syncs): "
              + json.dumps({"spans": table,
                            "syncs_outside": snap["syncs_outside"]}),
              file=sys.stderr)

    hooks.after.append(run)


def profiled_kernel_ms(fn, name: str, workdir: str):
    """Run fn() under `torch.profiler` and return kernel_ms_in_ranges of
    its trace for the spans named `name`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(workdir, "spans_profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return kernel_ms_in_ranges(events, name)


def kernel_ms_in_ranges(events: list, name: str):
    """Device ms of the kernels launched (their runtime or driver call,
    matched by correlation id) inside the `record_function` ranges named
    `name` of a Chrome trace: the union of their intervals.  None where
    no such range ran; 0 where the ranges launched no kernel."""
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == SPAN_CAT and e.get("name") == name)
    if not ranges:
        return None
    starts = [a for a, _ in ranges]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    launched = {e.get("args", {}).get("correlation") for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and inside(float(e["ts"]))}
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "kernel"
                   and e.get("args", {}).get("correlation") in launched])
    return sum(b - a for a, b in busy) * 1e-3


def snapshot(rec):
    """The run's snapshot, or None."""
    return rec["probes"].get(KEY)


def device_ms_by_call(snap, root: str, name: str):
    """Device ms of the spans named `name` inside each call of the
    outermost span `root`, one number a call (0 where none ran); None
    without a snapshot, device times, a call of root or such a span."""
    if not snap or root not in snap["spans"]:
        return None
    top = snap["spans"][root]
    if top["device_ms"] is None:
        return None
    by_call = {r: 0.0 for r, _, _ in top["each"]}
    found = False
    for path, s in snap["spans"].items():
        if path.startswith(root + "/") and path.rsplit("/", 1)[1] == name:
            found = True
            for r, _, dev in s["each"]:
                by_call[r] += dev
    return list(by_call.values()) if found else None


def median_device_ms(rec, root: str, name: str):
    per_call = device_ms_by_call(snapshot(rec), root, name)
    return statistics.median(per_call) if per_call else None


def syncs_per_step(rec):
    """Synchronising CUDA calls in the slice, inside and outside the
    program's spans, over its steps (views); None where not counted."""
    snap = snapshot(rec)
    if not snap or snap["syncs_outside"] is None \
            or not snap["window"]["steps"]:
        return None
    total = snap["syncs_outside"] + sum(s["syncs"]
                                        for s in snap["spans"].values())
    return total / snap["window"]["steps"]
