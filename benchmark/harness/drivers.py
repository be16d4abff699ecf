"""What every stage's driver shares (benchmark/stages/<stage>.py defines
the driver of its cells): the set-up's phase marks, and what the check
reads once the program's state is freed.

A driver builds the program, runs the steps the reference follows (or
keeps the answers the check samples), warms every shape of the cell in
`setup()`, and then runs its `window(seconds, tracing=False, steps=None)`:
for `seconds` by the host's clock, or `steps` steps (views) when given,
returning at least `steps` (the work attempted) and `seconds`, and the
time of each step under `step_s` (or `latency_s`)."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

CHECKED_STEPS = 3


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(tracing: bool, name: str):
    if not tracing:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.norm(t.detach().double()))
            for n, t in tensors.items()}


def host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu().clone() for n, t in tensors.items()}


class Driver:
    """Set-up, window and readings of one cell in one process."""

    # what the check reads once the program's state is gone; a stage adds
    # its own
    KEEP = ("cell", "seed", "device", "workdir", "scene", "fault", "tr",
            "phases", "params")

    def __init__(self, cell, seed: int, device: torch.device, workdir: str,
                 scene: Optional[dict] = None, fault: Optional[str] = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.workdir, self.scene, self.fault = workdir, scene, fault
        self.tr = cell.traffic
        self.phases: Dict[str, float] = {}
        self._t = self._t0 = time.time()

    def mark(self, phase: str):
        """Close a phase of the set-up (its seconds go to stderr)."""
        now = time.time()
        self.phases[phase] = round(now - self._t, 3)
        self._t = now

    def free(self):
        prog = getattr(self, "prog", None)
        if prog is not None:
            self.params = prog.params
            prog.free()
        for k in list(vars(self)):
            if k not in self.KEEP:
                delattr(self, k)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
