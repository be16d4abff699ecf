"""A cell of a stage the harness has never seen, added as new files and new
entries alone: the stage's module, a configuration, a traffic mix, limits,
metric readers and the manifest's entries.  The harness finds the stage by
the mix's name for it, runs the cell to its line, and judges it by the
stage's own numbers; no file that was there changes.  A workload whose
stage has no file is named by the manifest's check."""
import contextlib
import hashlib
import io
import json
import os
import shutil
import time

import pytest
import torch

from benchmark.harness import manifest
from benchmark.harness.main import main
from benchmark.tests.conftest import ROOT

# a product of a seeded batch and a seeded matrix, a batch a step; the
# check holds each batch's first answer to a float64 product
TOY_STAGE = '''
import time

import torch

from benchmark.harness.drivers import Driver as Base


class Driver(Base):
    KEEP = Base.KEEP + ("answers", "x", "w")

    def setup(self):
        g = torch.Generator().manual_seed(self.seed)
        d = self.cell.config["width"]
        self.w = torch.randn(d, d, generator=g)
        self.x = torch.randn(self.tr["batches"], self.tr["rows"], d,
                             generator=g)
        self.answers, self.k = {}, 0
        self.mark("build")

    def _step(self):
        i = self.k % self.x.shape[0]
        y = self.x[i] @ self.w
        if self.fault == "altered":
            y = y + 1e-3
        self.answers.setdefault(i, y)
        self.k += 1

    def window(self, seconds, tracing=False, steps=None):
        n, t0 = 0, time.perf_counter()
        step_s, t = [], t0
        while (n < steps) if steps is not None else (t - t0 < seconds):
            self._step()
            n += 1
            t, t_prev = time.perf_counter(), t
            step_s.append(t - t_prev)
        return {"steps": n, "rows": n * self.x.shape[1],
                "seconds": time.perf_counter() - t0, "step_s": step_s}


def numbers(driver, control=False):
    gap = 0.0
    for i, y in driver.answers.items():
        ref = driver.x[i].double() @ driver.w.double()
        gap = max(gap, float((y.double() - ref).abs().max()
                             / ref.abs().max()))
    return {"rel_gap": gap}
'''
ROWS_READER = '''
UNIT = "rows/s"
LAYER = None
MOVES = None


def read(rec):
    w = rec["window"]
    return w["rows"] / w["seconds"] if w["seconds"] > 0 else None
'''
STEPS_READER = '''
UNIT = "steps"
LAYER = "toy"
MOVES = "toy_rows_per_s"


def read(rec):
    return rec["window"]["steps"]
'''
CELL = "toy-64.toy-mix"


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d:
            continue
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture
def toy_root(tmp_path):
    """A copy of the benchmark with the toy stage's cell added by new files
    and entries; the digests of the files the copy had before."""
    root = tmp_path / "co"
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(str(bench))
    new = {"stages/toy.py": TOY_STAGE,
           "metrics/toy_rows_per_s.py": ROWS_READER,
           "metrics/toy_steps.py": STEPS_READER,
           "configs/toy-64.json": json.dumps({"width": 64}),
           "traffic/toy-mix.json": json.dumps(
               {"stage": "toy", "rows": 32, "batches": 4, "trace_steps": 3}),
           f"limits/{CELL}.json": json.dumps({"rel_gap": 1e-5})}
    for rel, text in new.items():
        (bench / rel).write_text(text)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy-64", "source": "x",
                           "file": "benchmark/configs/toy-64.json",
                           "reduced": [], "why": "throwaway"})
    man["workloads"].append({"name": CELL, "config": "toy-64",
                             "traffic": "toy-mix", "chips": 1,
                             "why": "throwaway"})
    man["end_to_end"].append({"name": "toy_rows_per_s", "unit": "rows/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock", "workloads": [CELL]})
    man["per_layer"].append({"name": "toy_steps", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "toy", "moves": "toy_rows_per_s",
                             "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, before


def _run(root, *flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--workload", CELL, "--seed", "2147483659", "--seconds",
                   "0.3", *flags], time.time(), device=torch.device("cpu"),
                  root=str(root), bench_dir=str(root / "benchmark"))
    lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    return rc, (json.loads(lines[-1]) if rc == 0 else None)


@pytest.mark.parametrize("trace,metrics", [
    ("0", {"toy_rows_per_s", "setup_s"}), ("1", {"toy_steps"})])
def test_new_stage_runs_from_new_files_alone(toy_root, trace, metrics):
    root, before = toy_root
    assert manifest.problems(str(root)) == []
    rc, out = _run(root, "--trace", trace)
    assert rc == 0
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == metrics
    assert list(out["check"]) == ["rel_gap"]
    after = _digests(str(root / "benchmark"))
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_stage_judges_by_its_own_numbers(toy_root):
    root, _ = toy_root
    rc, out = _run(root, "--fault", "altered")
    assert rc == 0
    assert out["correct"] is False and out["failed"] == 1


def test_a_stage_without_a_file_is_named(toy_root):
    root, _ = toy_root
    os.remove(root / "benchmark" / "stages" / "toy.py")
    assert f"{CELL}: missing stages/toy.py" in manifest.problems(str(root))
    mix = root / "benchmark" / "traffic" / "toy-mix.json"
    mix.write_text(json.dumps({"rows": 32}))
    assert f"{CELL}: bad stage None" in manifest.problems(str(root))
