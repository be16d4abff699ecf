"""The traced slice: torch.profiler over a fixed amount of the cell's work,
read back from its Chrome trace.

  window_s   the host span `bench.window` around the slice, which begins
             and ends synchronised with the device;
  busy_s     the union of the device's kernel, copy and set intervals
             inside it;
  kernels    (name, seconds) of every kernel inside it;
  device_ops the ten kernels that took the most device time in all;
  idle_gaps  the ten longest stretches inside the window where the device
             ran nothing, each named by the benchmark span and the
             innermost host op that were running at its middle."""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"


def profile(fn: Callable[[], dict], workdir: str, device) -> Tuple[dict, dict]:
    """Run fn() under the profiler inside the `bench.window` span; return
    (fn's result, the reduced trace)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return res, reduce_events(events)


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list) -> dict:
    """Chrome-trace events (ts and dur in microseconds) -> the slice's
    numbers in seconds."""
    win = next(e for e in events if e.get("name") == WINDOW
               and e.get("cat") == SPAN_CAT)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev, kernels = [], []
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                if e["cat"] == "kernel":
                    kernels.append((e["name"], (b - a) * 1e-6))
        elif e.get("cat") in ("cpu_op", SPAN_CAT) and e["name"] != WINDOW:
            host.append((a, b, e["name"], e["cat"]))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        over = [h for h in host if h[0] <= mid <= h[1]]
        spans = [h for h in over if h[3] == SPAN_CAT]
        ops = [h for h in over if h[3] == "cpu_op"]
        parts = [min(hs, key=lambda h: h[1] - h[0])[2]
                 for hs in (spans, ops) if hs]
        named.append([" > ".join(parts) or "host outside any op",
                      (b - a) * 1e-6])
    total = defaultdict(float)
    for name, s in kernels:
        total[name] += s
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": kernels, "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": named}


def kernel_seconds(trace: dict, patterns) -> float:
    """Device seconds of the kernels whose name holds any pattern."""
    return sum(s for name, s in trace["kernels"]
               if any(p in name for p in patterns))


def untraced_idle_pct(rec):
    """The share of the untraced window in which the device ran nothing:
    the traced slice's device time a step (or view), times the window's
    steps, against the window's length.  The profiler slows the host, not
    the device, so a host-bound cell's traced slice idles more than its
    window does."""
    t, traced, w = rec["trace"], rec["traced"], rec["window"]
    if not t or not traced or not traced["steps"] or not w["steps"] \
            or w["seconds"] <= 0:
        return None
    busy = t["busy_s"] / traced["steps"] * w["steps"]
    return 100.0 * (1.0 - busy / w["seconds"])
