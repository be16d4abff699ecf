"""Encoder factory (JAX ops/encoding.py, the reference's get_encoder): a
name -> (encode_fn, output dim, table initialiser).  Names: None,
'frequency' and 'frequency_torch' (one encoder), 'sh', 'hashgrid' and
'tiledgrid'.  Closed-form encoders return no initialiser; the grid
encoders return `init(generator, device=None)` of their table and encode
as f(table, x, bound=1, max_level=None)."""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

from .freq import freq_encode, freq_output_dim
from .hashgrid import HashGridSpec, hash_encode, init_hash_table
from .sh import sh_encode


def get_encoder(encoding: Optional[str] = "hashgrid", input_dim: int = 3,
                multires: int = 6, degree: int = 4, num_levels: int = 16,
                level_dim: int = 2, base_resolution: int = 16,
                log2_hashmap_size: int = 19,
                desired_resolution: Optional[int] = None,
                align_corners: bool = False, interpolation: str = "linear",
                **kwargs) -> Tuple[Callable, int, Optional[Callable]]:
    if encoding is None or encoding == "None":
        return (lambda x, **kw: x), input_dim, None
    if encoding in ("frequency", "frequency_torch"):
        return (partial(freq_encode, degree=multires),
                freq_output_dim(input_dim, multires), None)
    if encoding == "sh":
        return partial(sh_encode, degree=degree), degree * degree, None
    if encoding in ("hashgrid", "tiledgrid"):
        spec = HashGridSpec(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            align_corners=align_corners, interpolation=interpolation)

        def fn(table, x, bound: float = 1.0, max_level=None):
            return hash_encode(table, x, spec, bound=bound,
                               max_level=max_level)

        fn.spec = spec
        return fn, spec.output_dim, partial(init_hash_table, spec=spec)
    raise NotImplementedError(f"Unknown encoding: {encoding}")
