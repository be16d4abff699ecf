"""BENCHMARK.json against the benchmark's contract, and the harness's
claim that a cell, a configuration, a traffic mix or a metric is added
with new files and new entries alone."""
import hashlib
import json
import os
import shutil

import pytest

from benchmark.harness import manifest
from benchmark.tests.conftest import ROOT

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_and_entry_keys():
    m = _man()
    assert set(m) == TOP
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lengths():
    m = _man()
    assert manifest.problems(ROOT) == []
    for entry in m["configs"] + m["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for c in m["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
    for p in m["per_layer"]:
        assert 1 <= len(p["layer"]) <= 200
    for e in m["end_to_end"] + m["per_layer"]:
        assert e["better"] in ("lower", "higher")
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(m)) <= 64 * 1024


def test_bounds_and_run_length():
    m = _man()
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert [e["bound"] for e in m["end_to_end"]
            if e["name"] == "setup_s"] == [0.25]
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # the full check of 24 cells fits its budget
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_paths_and_command():
    m = _man()
    assert m["paths"] == ["benchmark"]
    assert len(m["command"]) <= 32
    for w in m["command"][1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert w.startswith("benchmark/")
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/")


def test_every_cell_resolves_and_reports():
    m = _man()
    for w in m["workloads"]:
        cell = manifest.cell(ROOT, w["name"])
        assert os.path.exists(manifest.stage_path(cell.bench_dir,
                                                  cell.traffic["stage"]))
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for p in cell.per_layer:
            assert p["moves"] in e2e


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_is_new_files_and_entries(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    by files and entries alone: the harness finds them by name, and no
    file that was there changes."""
    root = tmp_path / "co"
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(str(bench))

    cfg = json.loads((bench / "configs" / "hashgrid.json").read_text())
    cfg["field"]["num_steps"] = [64, 32, 16]
    (bench / "configs" / "hashgrid-short.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "stage1-8k.json").read_text())
    mix["flags"]["num_points"] = 2 ** 17
    (bench / "traffic" / "stage1-4k.json").write_text(json.dumps(mix))
    (bench / "limits" / "hashgrid-short.stage1-4k.json").write_text(
        json.dumps({"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}))
    (bench / "metrics" / "steps_seen.py").write_text(
        'UNIT = "steps"\nLAYER = "loop"\nMOVES = "train_rays_per_s"\n\n\n'
        'def read(rec):\n    return rec["window"]["steps"]\n')

    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "hashgrid-short", "source": "x",
                           "file": "benchmark/configs/hashgrid-short.json",
                           "reduced": ["num_steps"], "why": "throwaway"})
    man["workloads"].append({"name": "hashgrid-short.stage1-4k",
                             "config": "hashgrid-short",
                             "traffic": "stage1-4k", "chips": 1,
                             "why": "throwaway"})
    for e in man["end_to_end"]:
        if e["name"] == "train_rays_per_s":
            e["workloads"].append("hashgrid-short.stage1-4k")
    man["per_layer"].append({"name": "steps_seen", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "loop", "moves": "train_rays_per_s",
                             "workloads": ["hashgrid-short.stage1-4k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    assert manifest.problems(str(root)) == []
    cell = manifest.cell(str(root), "hashgrid-short.stage1-4k")
    assert cell.config["field"]["num_steps"] == [64, 32, 16]
    assert cell.traffic["flags"]["num_points"] == 2 ** 17
    assert [p["name"] for p in cell.per_layer][-1] == "steps_seen"
    assert cell.metric_module("steps_seen").read(
        {"window": {"steps": 7}}) == 7
    after = _digests(str(bench))
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("name", ["a b", "x/y", "-lead", "a" * 65])
def test_bad_names_are_caught(tmp_path, name):
    root = tmp_path / "co"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = _man()
    man["workloads"][0]["name"] = name
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert any("bad name" in p for p in manifest.problems(str(root)))
