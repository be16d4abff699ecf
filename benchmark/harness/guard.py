"""The measured process runs the PyTorch port alone: no module of JAX, of
its libraries or of the JAX package may be loaded in it.  Modules are
compared by their top-level name (the part before the first dot), whole:
`sanerf_hq_tpu_torch` is the port and passes."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "sanerf_hq_tpu")


def forbidden(modules: Iterable[str]) -> List[str]:
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(tops & set(FORBIDDEN))


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
