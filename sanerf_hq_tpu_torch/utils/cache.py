"""Ring buffer of recent stage-2 distill batches (the JAX package's
utils/cache.py): the SAM encoder runs only every cache_interval steps once
the ring is full, and the steps between reuse a stored batch.

`get` draws the batch from a seeded torch.Generator; the JAX ring draws it
with the global `random.choice`, which nothing seeds, so its draws cannot
be reproduced (the port's second deliberate difference, beside
`load_object_masks`'s seeded top-up)."""
from __future__ import annotations

from typing import Any, List, Optional

import torch


class Cache:
    def __init__(self, size: int = 100,
                 generator: Optional[torch.Generator] = None):
        self.size = size
        self.data: List[Any] = []
        self.ptr = 0
        self.generator = generator

    def full(self) -> bool:
        return len(self.data) == self.size

    def insert(self, x):
        """Append while there is room; then replace the oldest entry."""
        if len(self.data) < self.size:
            self.data.append(x)
        else:
            self.data[self.ptr] = x
            self.ptr = (self.ptr + 1) % self.size

    def get(self):
        """A uniformly drawn entry."""
        i = int(torch.randint(len(self.data), (), generator=self.generator))
        return self.data[i]

    def __len__(self):
        return len(self.data)
