"""Fixtures of the benchmark's own tests (python -m pytest benchmark/tests):
a checkout-like copy of the benchmark with tiny cells, and a runner of
one cell on the CPU that returns its exit code and its last JSON line."""
import json
import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402
from benchmark.tests import tiny  # noqa: E402


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def run_cell(tiny_root):
    """run_cell(cell, *flags) -> (exit code, last stdout line as a dict)."""

    def run(cell, *flags, seed=2147483659, seconds=0.5):
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), *flags], time.time(),
                      device=torch.device("cpu"), root=tiny_root,
                      bench_dir=os.path.join(tiny_root, "benchmark"))
        lines = [l for l in buf.getvalue().splitlines() if l.strip()]
        return rc, (json.loads(lines[-1]) if rc == 0 else None)

    return run
