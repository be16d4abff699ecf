"""Synchronising CUDA calls a training step: the program's sync counter
(harness/spans.py; `torch.cuda.set_sync_debug_mode("warn")`) over the
slice's steps, inside and outside the program's spans (the job loop's
metric reads count)."""
from benchmark.harness import spans

UNIT = "syncs/step"
LAYER = "step"
MOVES = "train_rays_per_s"


def install(hooks):
    spans.install(hooks)


def read(rec):
    return spans.syncs_per_step(rec)
