"""What the host did while the window ran, for stderr only (`host stats`,
beside `setup phases`; never in the result line): the window's time a step
(median, 90th percentile, and in each 5 s of the window), the main
thread's CPU time a step and its share of the window, the process's, the
CPUs the process may run on and ran on, its context switches, the host's
load, and the Python collector's full collections.  They tell a spread
between processes (placement, the host's state) from one inside a run
(stalls, collections, a warm-up not settled).

Every reading is of this process, or read-only from /proc; a reading the
host does not offer is left out."""
from __future__ import annotations

import gc
import os
import resource
import statistics
import time
from typing import Dict, List, Optional

BLOCK_S = 5.0


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _status() -> Dict[str, str]:
    out = {}
    for line in (_read("/proc/self/status") or "").splitlines():
        k, _, v = line.partition(":")
        if k in ("voluntary_ctxt_switches", "nonvoluntary_ctxt_switches",
                 "Threads"):
            out[k] = v.strip()
    return out


def _last_cpu() -> Optional[int]:
    stat = _read("/proc/self/stat")
    return int(stat.rsplit(")", 1)[1].split()[36]) if stat else None


def _loadavg() -> Optional[List[float]]:
    s = _read("/proc/loadavg")
    return [float(x) for x in s.split()[:3]] if s else None


def step_readings(step_s: List[float]) -> dict:
    """Median and 90th percentile ms a step, and the mean ms a step in each
    BLOCK_S of the window, in order."""
    ms = sorted(1e3 * s for s in step_s)
    blocks, acc, n = [], 0.0, 0
    for s in step_s:
        acc, n = acc + s, n + 1
        if acc >= BLOCK_S:
            blocks.append(round(1e3 * acc / n, 3))
            acc, n = 0.0, 0
    return {"n": len(ms), "median": round(statistics.median(ms), 3),
            "p90": round(ms[int(0.9 * (len(ms) - 1))], 3),
            "max": round(ms[-1], 3), "block_ms": blocks}


class HostStats:
    """start() before the window, stop(window) after it."""

    def _sample(self) -> dict:
        return {"status": _status(), "cpu": _last_cpu(),
                "load": _loadavg(), "gc2": gc.get_stats()[2]["collections"],
                "ru": resource.getrusage(resource.RUSAGE_SELF),
                "thread_s": time.thread_time(), "t": time.perf_counter()}

    def start(self):
        self.a = self._sample()

    def stop(self, win: dict) -> dict:
        a, b = self.a, self._sample()
        wall = b["t"] - a["t"]
        out = {"wall_s": round(wall, 3)}
        steps = win.get("step_s") or win.get("latency_s")
        if steps:
            out["step_ms"] = step_readings(steps)
            out["main_thread_cpu_ms_a_step"] = round(
                (b["thread_s"] - a["thread_s"]) * 1e3 / len(steps), 4)
        out["main_thread_cpu_share"] = round(
            (b["thread_s"] - a["thread_s"]) / wall, 4)
        out["process_cpu_share"] = {
            "user": round((b["ru"].ru_utime - a["ru"].ru_utime) / wall, 4),
            "system": round((b["ru"].ru_stime - a["ru"].ru_stime) / wall, 4)}
        out["cpus_allowed"] = sorted(os.sched_getaffinity(0))
        out["ran_on"] = [a["cpu"], b["cpu"]]
        out["threads"] = b["status"].get("Threads")
        for k in ("voluntary_ctxt_switches", "nonvoluntary_ctxt_switches"):
            if k in a["status"] and k in b["status"]:
                out[k] = int(b["status"][k]) - int(a["status"][k])
        out["loadavg"] = [a["load"], b["load"]]
        out["gc2_collections"] = b["gc2"] - a["gc2"]
        return out
