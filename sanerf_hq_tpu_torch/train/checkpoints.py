"""Checkpoints with the reference's latest / best / rolling-window semantics,
in the port's own format: one `torch.save` file of the training state
(step, model, optimizer, EMA and EMA counter; `TrainState.state_dict`).

<workspace>/checkpoints/step_{step:08d}.pt, the newest `max_keep` kept;
best.pt for the best eval metric.  Under a process group rank 0 writes and
every rank waits for it at a barrier.  The JAX package's orbax checkpoints
are read by the repository's `convert_jax_ckpt.py` (under JAX), which
writes their parameters as the `.npz` that models/convert.py carries
across (`--ckpt x.npz`, `--init_ckpt x.npz`).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..parallel.mesh import barrier, is_main_process


class CheckpointManager:
    def __init__(self, workspace: str, max_keep: int = 2):
        self.dir = os.path.abspath(os.path.join(workspace, "checkpoints"))
        self.max_keep = max_keep

    def _steps(self):
        if not os.path.isdir(self.dir):
            return []
        return sorted(f for f in os.listdir(self.dir)
                      if f.startswith("step_") and f.endswith(".pt"))

    def save(self, step: int, state: dict, best: bool = False) -> str:
        name = "best.pt" if best else f"step_{step:08d}.pt"
        path = os.path.join(self.dir, name)
        if is_main_process():
            os.makedirs(self.dir, exist_ok=True)
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)  # a reader never sees a partial file
            if not best:
                for old in self._steps()[:-self.max_keep]:
                    os.remove(os.path.join(self.dir, old))
        barrier()
        return path

    def latest_path(self) -> Optional[str]:
        steps = self._steps()
        return os.path.join(self.dir, steps[-1]) if steps else None

    def restore(self, map_location=None):
        """The newest checkpoint's training state, or None if there is none."""
        path = self.latest_path()
        if path is None:
            return None
        return torch.load(path, map_location=map_location, weights_only=True)
