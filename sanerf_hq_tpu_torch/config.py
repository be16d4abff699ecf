"""Static configuration: the `Config` fields the inference slice reads.

A copy of the matching fields of the JAX package's `Config` (defaults
unchanged, including the post-parse hard overrides bound=128 and
contract=True), plus `device`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # paths / workspace
    path: str = ""
    workspace: str = "workspace"
    seed: int = 0
    ckpt: str = ""  # .npz of JAX parameters (models/convert.py); "" = seeded init

    # testing
    test: bool = False

    # dataset
    test_split: str = "val"
    val_type: str = "default"
    downscale: int = 1
    bound: float = 128.0
    scale: float = -1.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    enable_cam_center: bool = False
    min_near: float = 0.2
    data_type: str = "mip"

    # rendering
    num_steps: Tuple[int, ...] = (128, 64, 32)
    contract: bool = True
    background: str = "last_sample"  # white | random | last_sample
    max_ray_batch: int = 4096 * 4

    # field
    field_type: str = "hashgrid"
    cp_rank: int = 64
    cp_res: int = 256
    density_bias: float = 0.0

    # port: where tensors live ("cuda" unless the caller asks for "cpu")
    device: Optional[str] = None

    @property
    def grid_bound(self) -> float:
        """Bound used for grid queries: contraction maps the world into
        [-2, 2]^3."""
        return 2.0 if self.contract else self.bound

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
