"""The plain reference against the port at tiny sizes on the CPU, the
benchmark's scene against the program's loader, and the reference's
independence: it imports nothing of the port and nothing of JAX."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import guard
from benchmark.harness.scene import llff_poses, write_scene
from benchmark.reference.common import round_to
from benchmark.reference.fields import grid_rows, hash_encode
from benchmark.tests.conftest import ROOT

REF = os.path.join(ROOT, "benchmark", "reference")


@pytest.mark.parametrize("cell", ["tiny-mlp.s1", "tiny-hash.s1",
                                  "tiny-hash.s3", "tiny-mlp.r"])
def test_program_matches_reference(run_cell, cell):
    rc, out = run_cell(cell)
    assert rc == 0
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("spec", [
    dict(num_levels=16, level_dim=2, base_resolution=16,
         log2_hashmap_size=19, desired_resolution=4096),
    dict(num_levels=5, level_dim=2, base_resolution=16,
         log2_hashmap_size=17, desired_resolution=128),
    dict(num_levels=16, level_dim=8, base_resolution=16,
         log2_hashmap_size=19, desired_resolution=512)])
def test_hash_encoding_matches_the_port(spec):
    from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
    from sanerf_hq_tpu_torch.ops.hashgrid import hash_encode as port

    ps = HashGridSpec(**spec)
    assert grid_rows(spec) == ps.total_params
    g = torch.Generator().manual_seed(0)
    table = torch.rand((ps.total_params, ps.level_dim), generator=g) - 0.5
    x = (torch.rand((300, 3), generator=g) - 0.5) * 4.4  # some outside
    np.testing.assert_allclose(hash_encode(table, x, spec, 2.0).numpy(),
                               port(table, x, ps, bound=2.0).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_scene_loads_as_the_reference_sees_it(tmp_path):
    from sanerf_hq_tpu_torch.data.provider import load_scene

    spec = {"kind": "rich", "n_views": 3, "H": 12, "W": 16,
            "mask_object": 2}
    d = write_scene(str(tmp_path), spec)
    s = load_scene(str(tmp_path), "llff", 1, -1.0, (0, 0, 0), False, 128.0)
    np.testing.assert_allclose(s.poses, llff_poses(d["poses"]), atol=1e-6)
    np.testing.assert_array_equal((s.images * 255).round().astype(np.uint8),
                                  d["images"])
    assert (s.H, s.W) == (12, 16)


def test_precision_modes():
    x = torch.tensor([1.0 + 2 ** -12, 3.14159265, -1e-3, 100.0])
    assert torch.equal(round_to(x, "fp32"), x)
    t = round_to(x, "tf32")
    # 10 mantissa bits: 1 + 2^-12 rounds to 1
    assert t[0] == 1.0 and abs(t[1] - 3.14159265) < 2 ** -9
    b = round_to(x, "bf16")
    assert torch.equal(b, x.to(torch.bfloat16).float())
    f = round_to(x, "fp8")
    assert f[3] == 100.0  # the largest magnitude maps to 448 exactly
    assert 0 < abs(f[2] - x[2]) < 1e-3


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_the_port_nor_jax():
    for f in os.listdir(REF):
        if f.endswith(".py"):
            mods = list(_imports(os.path.join(REF, f)))
            assert not guard.forbidden(mods), f
            assert not any(m.split(".")[0] == "sanerf_hq_tpu_torch"
                           for m in mods), f


def test_no_forbidden_module_loaded_by_the_harness_or_reference():
    """In a fresh interpreter: the reference loads nothing of the port or
    of JAX; a tiny run of every stage loads nothing of JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.steps\n"
        "from benchmark.harness import guard\n"
        "assert not guard.loaded_forbidden()\n"
        "assert 'sanerf_hq_tpu_torch' not in sys.modules\n"
        "import tempfile, time, torch\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.harness.main import main\n"
        "root = tiny.make(tempfile.mkdtemp())\n"
        "for c in ('tiny-mlp.s1', 'tiny-mlp.r'):\n"
        "    assert main(['--workload', c, '--seed', '1', '--seconds',"
        " '0.2'], time.time(), device=torch.device('cpu'), root=root,"
        " bench_dir=root + '/benchmark') == 0\n"
        "assert not guard.loaded_forbidden(), guard.loaded_forbidden()\n"
        "print('clean')\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["sanerf_hq_tpu_torch.ops", "jaxtyping",
                            "flaxen"]) == []
    assert guard.forbidden(["jax.numpy", "sanerf_hq_tpu.ops",
                            "jaxlib"]) == ["jax", "jaxlib", "sanerf_hq_tpu"]
