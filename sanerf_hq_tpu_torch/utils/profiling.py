"""Timing and tracing helpers: the device time of a call (CUDA events on
the card, the host clock on the CPU), a render rate in Mrays/s, a
`torch.profiler` trace context, and seeding.
"""
from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device


def device_time(fn: Callable, *args, iters: int = 6,
                device=None) -> float:
    """Seconds a call of fn(*args) takes, the mean of `iters` calls after
    one warm-up: between CUDA events on a CUDA device, on the host clock
    on the CPU.  device: where fn runs (default the card; the CPU must be
    asked for)."""
    device = resolve_device(device)
    fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def mrays_per_sec(render_fn, rays_o, rays_d, iters: int = 6) -> float:
    """Million rays a second of render_fn(rays_o, rays_d), timed on the
    rays' device."""
    t = device_time(render_fn, rays_o, rays_d, iters=iters,
                    device=rays_o.device)
    return rays_o.shape[0] / t / 1e6


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block (the host, and the card where
    there is one), its Chrome trace written to logdir/trace.json on exit.
    Yields the profiler (key_averages() for the sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def seed_everything(seed: int, device=None) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a
    torch.Generator on `device` (default the card) seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    gen = torch.Generator(resolve_device(device))
    gen.manual_seed(seed)
    return gen
