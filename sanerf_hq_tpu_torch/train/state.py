"""Training state: the field, Adam, the learning-rate schedule and the EMA.

  - Adam with b1 0.9, b2 0.999, eps 1e-15;
  - lr(t) = lr * 0.1 ** min(t / iters, 1), update t (counted from 0) taking
    lr(t), as optax's schedule does; set on the optimizer before each
    update, so the schedule carries no state of its own;
  - per-parameter lr scales (`mlp_field_lr_scales`): the MLP field's dense
    weights take 0.05x the base lr and its CP bases 1x, one Adam parameter
    group per scale;
  - an EMA of the parameters with decay min(0.95, (1 + n) / (10 + n)) at
    its n-th update (1-based), updated once an epoch by the trainer; the
    stage-1 eval renders use it;
  - the stage hand-off: the parameters an init checkpoint holds are frozen
    by name (`freeze_mask_from_loaded`): requires_grad False and left out
    of Adam, where the JAX state zeroes their updates.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Set

import torch


def exp_decay_lr(base_lr: float, total_iters: int, step: int) -> float:
    return base_lr * 0.1 ** min(step / total_iters, 1.0)


def mlp_field_lr_scales(model, mlp_scale: float = 0.05) -> Dict[str, float]:
    """{parameter name: lr multiplier}: feature tables (CP bases `cp_*`,
    s_grid / m_grid) keep the base lr, dense weights get mlp_scale."""
    def is_table(name):
        return any(p in ("s_grid", "m_grid") or p.startswith("cp_")
                   for p in name.split("."))

    return {n: (1.0 if is_table(n) else mlp_scale)
            for n, _ in model.named_parameters()}


def freeze_mask_from_loaded(model, loaded: Dict[str, torch.Tensor]) -> Set[str]:
    """Names of the model's parameters that `loaded` (an init checkpoint's
    state_dict) holds: the reference freezes exactly those."""
    return {n for n, _ in model.named_parameters() if n in loaded}


@torch.no_grad()
def partial_load(model, loaded: Dict[str, torch.Tensor]) -> Set[str]:
    """Copy the tensors of `loaded` whose name and shape match a parameter
    of the model (a strict=False load); returns the names copied."""
    done = set()
    for name, p in model.named_parameters():
        v = loaded.get(name)
        if v is not None and tuple(v.shape) == tuple(p.shape):
            p.copy_(v)
            done.add(name)
    return done


class TrainState:
    """The field being trained, its optimizer, the step count and the EMA
    copy of the field (`ema_model`, which the stage-1 eval renders use).
    `frozen` names parameters that are not trained; with every parameter
    frozen (stage 2's cache and the decode, over a stage-1 field) there is
    no optimizer."""

    def __init__(self, model, base_lr: float, total_iters: int,
                 lr_scales: Optional[Dict[str, float]] = None,
                 ema_decay: float = 0.95, frozen: Iterable[str] = ()):
        self.model = model
        self.base_lr = base_lr
        self.total_iters = total_iters
        self.ema_decay = ema_decay
        self.step = 0
        self.ema_updates = 0
        self.frozen = frozenset(frozen)
        scales = lr_scales or {}
        groups: Dict[float, list] = {}
        for name, p in model.named_parameters():
            if name in self.frozen:
                p.requires_grad_(False)
                continue
            groups.setdefault(scales.get(name, 1.0), []).append(p)
        self.optimizer = torch.optim.Adam(
            [{"params": ps, "scale": sc} for sc, ps in groups.items()],
            lr=base_lr, betas=(0.9, 0.999), eps=1e-15) if groups else None
        self.ema_model = copy.deepcopy(model).requires_grad_(False)

    def lr(self, step: Optional[int] = None) -> float:
        return exp_decay_lr(self.base_lr, self.total_iters,
                            self.step if step is None else step)

    def apply_gradients(self):
        """One Adam update with the grads in the parameters' .grad."""
        lr = self.lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["scale"]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    @torch.no_grad()
    def update_ema(self):
        n = self.ema_updates + 1
        d = min(self.ema_decay, (1.0 + n) / (10.0 + n))
        for e, p in zip(self.ema_model.parameters(), self.model.parameters()):
            e.mul_(d).add_(p, alpha=1.0 - d)
        self.ema_updates = n

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": (self.optimizer.state_dict()
                              if self.optimizer is not None else {}),
                "ema": self.ema_model.state_dict(),
                "ema_updates": self.ema_updates}

    def load_state_dict(self, state: dict, weights_only: bool = False):
        """weights_only skips Adam's state: a checkpoint written under
        another freeze set (a stage-3 field resumed for --test without its
        init checkpoint), whose optimizer load raises ValueError."""
        if not weights_only and self.optimizer is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.ema_model.load_state_dict(state["ema"])
        self.ema_updates = int(state["ema_updates"])

    @torch.no_grad()
    def load_weights(self, state_dict: dict):
        """Weights only (e.g. carried across from JAX): the field and its
        EMA both start from them."""
        self.model.load_state_dict(state_dict)
        self.ema_model.load_state_dict(state_dict)
