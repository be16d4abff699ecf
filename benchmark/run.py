"""Benchmark of the PyTorch / CUDA port (sanerf_hq_tpu_torch) on one card.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout.  One process runs one cell of BENCHMARK.json
once: it makes the scene and the parameters from the seed, builds the
program, checks its first steps (or sampled answers) against the plain
reference in benchmark/reference/, warms every shape, measures for
--seconds, and prints one JSON line: the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics read from a profiler trace.  Builds
go to the checkout's build/ directory.

The process runs its thread pools at one intra-op and one inter-op
thread: the port's steps run on the card, its host path on the main
thread and autograd's device thread, which no pool serves, and a run is
one process with few threads.  Nothing of the machine is set."""
import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    sys.exit(main(sys.argv[1:], T0))
