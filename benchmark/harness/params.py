"""Parameters from the seed, made on the device in two large draws (one
uniform, one normal) and copied into the program's field; the benchmark
keeps its own copy for the reference.  Each parameter's distribution is
the first rule of the configuration's `init` list whose pattern matches
its name:
  ["pattern", "uniform", a]  U(-a, a)
  ["pattern", "fan_in"]      U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in the
                             last dimension
  ["pattern", "normal", s]   N(0, s^2)
  ["pattern", "keep"]        as the program built it."""
from __future__ import annotations

import re
from typing import Dict

import torch


def _rule(rules, name):
    for r in rules:
        if re.search(r[0], name):
            return r
    raise KeyError(f"no init rule matches parameter {name!r}")


@torch.no_grad()
def fill(model, rules, seed: int, device) -> Dict[str, torch.Tensor]:
    """Draw every parameter of `model` from `seed` and return a copy of
    them by name."""
    named = sorted(model.named_parameters())
    kinds = [_rule(rules, n) for n, _ in named]
    n_uni = sum(p.numel() for (_, p), r in zip(named, kinds)
                if r[1] in ("uniform", "fan_in"))
    n_norm = sum(p.numel() for (_, p), r in zip(named, kinds)
                 if r[1] == "normal")
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    uni = torch.rand(n_uni, generator=gen, device=device)
    norm = torch.randn(n_norm, generator=gen, device=device)
    iu = inn = 0
    out = {}
    for (name, p), r in zip(named, kinds):
        k = p.numel()
        if r[1] in ("uniform", "fan_in"):
            a = r[2] if r[1] == "uniform" else p.shape[-1] ** -0.5
            p.copy_(((uni[iu:iu + k] * 2.0 - 1.0) * a).view_as(p))
            iu += k
        elif r[1] == "normal":
            p.copy_((norm[inn:inn + k] * r[2]).view_as(p))
            inn += k
        out[name] = p.detach().clone()
    return out
