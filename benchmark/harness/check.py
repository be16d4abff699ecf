"""How `correct` is decided: the reference (benchmark/reference) follows
what the timed path produced, from the inputs the benchmark made; the
cell's stage (benchmark/stages/<stage>.py `numbers`) gives the numbers,
and each that the cell's limits file (`benchmark/limits/<cell>.json`)
names is held to its limit (`judge`).

The numbers of a training stage's three checked steps (they go through
the window's own entry) against the reference's three steps from the
same parameters, draws and views:
  loss_gap    the widest |loss - loss_ref| / |loss_ref| over the steps;
  grad_gap    over the trained leaves, |norm(g) - norm(g_ref)| / max(
              norm(g_ref), the median leaf's norm(g_ref)), g the first
              step's gradient as Adam holds it (exp_avg / (1 - b1));
  change_gap  the same of the parameters' change over the three steps,
              over the leaves whose reference gradient is at least a
              thousandth of the median leaf's (the others move under Adam
              by round-off alone);
  change_median  the median leaf's change gap: where the widest leaf's
              is the round-off of whichever leaf's later steps under
              Adam's eps of 1e-15, and swings from seed to seed, a cell
              compares this one (a step that leaves the state unchanged
              reads 1 either way)."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np


def leaf_gaps(prog: dict, ref: dict):
    """Per leaf: the first gradient's gap, and the change's over the
    leaves that move."""
    g_ref = ref["grads"]
    med = statistics.median(g_ref.values())
    grads = {n: abs(prog["grads"].get(n, 0.0) - g) / max(g, med, 1e-30)
             for n, g in g_ref.items()}
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * med]
    c_ref = ref["changes"]
    medc = statistics.median(c_ref[n] for n in moved)
    changes = {n: abs(prog["changes"].get(n, 0.0) - c_ref[n])
               / max(c_ref[n], medc, 1e-30) for n in moved}
    return grads, changes


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if not all(np.isfinite(prog["losses"])):
        loss_gap = float("inf")
    grads, changes = leaf_gaps(prog, ref)
    return {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
            "change_gap": max(changes.values()),
            "change_median": statistics.median(changes.values())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(the numbers the limits name, those not finite or over their
    limit)."""
    nums = {k: v for k, v in numbers.items() if k in limits}
    over: List[str] = [k for k, v in nums.items()
                       if not (math.isfinite(v) and v <= limits[k])]
    return nums, over
