"""The last line a run prints, with --trace 0 and 1, and the run's refusals:
no card, and a broken timed path or the control in the program's place
coming out not correct."""
import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _schema(out, trace: bool):
    assert KEYS <= set(out)
    assert list(out)[-1] == "check"
    assert isinstance(out["correct"], bool)
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, c in out["check"].items():
        assert set(c) == {"value", "limit"}
    if trace:
        assert dev["busy_s"] >= 0 and dev["window_s"] > 0
        bd = out["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell,e2e", [
    ("tiny-mlp.s1", {"train_rays_per_s", "setup_s"}),
    ("tiny-hash.s1", {"train_rays_per_s", "setup_s"}),
    ("tiny-mlp.r", {"render_rays_per_s", "view_ms.p95", "setup_s"})])
def test_end_to_end_line(run_cell, cell, e2e):
    rc, out = run_cell(cell)
    assert rc == 0
    _schema(out, trace=False)
    assert set(out["metrics"]) == e2e


@pytest.mark.parametrize("cell,layer", [
    ("tiny-mlp.s1", {"device_idle_pct.train", "train_mfu"}),
    ("tiny-hash.s3", {"device_idle_pct.train", "train_mfu",
                      "error_map_rebuild_ms"}),
    ("tiny-mlp.r", {"device_idle_pct.render", "render_mfu"})])
def test_traced_line(run_cell, cell, layer):
    # a window long enough for the tiny stage 3's first rebuild
    rc, out = run_cell(cell, "--trace", "1", seconds=2.0)
    assert rc == 0
    _schema(out, trace=True)
    # kernel readers find no kernel on the CPU and stay silent
    assert set(out["metrics"]) == layer


@pytest.mark.parametrize("cell,fault", [
    ("tiny-mlp.s1", "frozen"), ("tiny-mlp.s1", "half"),
    ("tiny-hash.s1", "frozen"), ("tiny-hash.s1", "half"),
    ("tiny-hash.s3", "frozen"), ("tiny-hash.s3", "half"),
    ("tiny-mlp.r", "half"), ("tiny-mlp.r", "altered")])
def test_broken_timed_path_is_not_correct(run_cell, cell, fault):
    rc, out = run_cell(cell, "--fault", fault)
    assert rc == 0
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("cell", ["tiny-mlp.s1", "tiny-mlp.r"])
def test_control_is_not_correct(run_cell, cell):
    """The reference one precision step down (fp8 products) in the
    program's place fails a number."""
    rc, out = run_cell(cell, "--control")
    assert rc == 0
    assert out["correct"] is False


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "mlp-cp64.stage1-8k", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only the benchmark, the run fails."""
    import shutil
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from benchmark.harness.main import main\n"
            "sys.exit(main(['--workload', 'mlp-cp64.stage1-8k', '--seed', "
            "'1', '--seconds', '1'], time.time(), "
            "device=torch.device('cpu'), root=%r))\n") % (str(tmp_path),
                                                           str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip().startswith("{")
    assert "sanerf_hq_tpu_torch" in out.stderr


@pytest.mark.gpu
def test_control_on_the_card_at_the_cells_size():
    """On the card: each cell's control, at the cell's own size, comes
    out not correct (run: python -m pytest -m gpu
    benchmark/tests/test_bench_schema.py)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for cell in cells:
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
             "--workload", cell, "--seed", "5", "--seconds", "4",
             "--trace", "0", "--control"], capture_output=True, text=True,
            cwd=ROOT, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"] is False
