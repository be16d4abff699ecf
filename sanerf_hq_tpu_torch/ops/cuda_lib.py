"""Build the CUDA sources under `sanerf_hq_tpu_torch/csrc/` with nvcc and
load them with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>_<hash>.so` at the repository
root (the hash covers the source, the shared `csrc/*.cuh` headers and the
flags, so an edit rebuilds).  The sources have a plain C interface and
include no PyTorch header, so a build takes seconds.  Nothing is built when
a module is imported: the first launch builds, and `build_all()` builds
every source at once, one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), _target(name)


def _finish(name: str, proc, tmp: Path, target: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: no reader sees a partial file
    return log


def build_all() -> Dict[str, str]:
    """Build every source that has no up-to-date library, all nvcc
    processes started together.  Returns {name: nvcc log} of the builds."""
    jobs = {n: _start(n) for n in sources() if not _target(n).exists()}
    return {n: _finish(n, *job) for n, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            _finish(name, *_start(name))
        lib = _loaded[name] = ctypes.CDLL(str(target))
        lib.sanerf_error_string.argtypes = [ctypes.c_int]
        lib.sanerf_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.sanerf_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
