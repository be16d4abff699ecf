"""PyTorch / CUDA port of SANeRF-HQ-TPU for NVIDIA Hopper.

The JAX package `sanerf_hq_tpu` is the reference; this package mirrors its
layout (`ops/`, `models/`, `render/`, `data/`, `train/`, `cli.py`) in plain
PyTorch, and every Pallas kernel on a ported path becomes a hand-written
CUDA kernel under `csrc/` with a plain PyTorch twin beside its wrapper.

Slices 1 and 2 cover stage 1 of the flagship field (`--field_type mlp
--cp_rank 64`): training, `python -m sanerf_hq_tpu_torch <scene>
--field_type mlp`, and inference, the same with `--test`.  Entry points run
on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
