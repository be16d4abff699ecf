"""Synchronising CUDA calls a cache view: the program's sync counter
(harness/spans.py; `torch.cuda.set_sync_debug_mode("warn")`) over the
slice's views, inside and outside the program's spans."""
from benchmark.harness import spans

UNIT = "syncs/view"
LAYER = "step"
MOVES = "view_ms.p95"


def install(hooks):
    spans.install(hooks)


def read(rec):
    return spans.syncs_per_step(rec)
