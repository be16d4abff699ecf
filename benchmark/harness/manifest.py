"""The benchmark's manifest, `BENCHMARK.json` at the root of the checkout,
and the files each name in it resolves to:

  - a configuration `<config>`: `benchmark/configs/<config>.json`;
  - a traffic mix `<traffic>`: `benchmark/traffic/<traffic>.json`;
  - a cell `<config>.<traffic>`: those two, and its limits
    `benchmark/limits/<cell>.json`;
  - a metric `<metric>`: the reader
    `benchmark/metrics/<metric with dots as underscores>.py`;
  - a stage `<stage>`, the mix's `stage` key: its driver, its numbers of
    the check, its work counts and its scene, `benchmark/stages/<stage>.py`
    (benchmark/stages/__init__.py says what it defines).
Nothing here names a cell, a mix, a stage or a metric: a new one is new
files and new entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root_of(bench_dir: str = HERE) -> str:
    return os.path.dirname(bench_dir)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str

    def metric_module(self, name: str):
        return load_metric(self.bench_dir, name)

    def stage_module(self):
        return load_stage(self.bench_dir, self.traffic["stage"])


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_path(bench_dir: str, name: str) -> str:
    return os.path.join(bench_dir, "metrics", name.replace(".", "_") + ".py")


def stage_path(bench_dir: str, name: str) -> str:
    return os.path.join(bench_dir, "stages", name + ".py")


def _load(path: str, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"[.\-]", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(bench_dir: str, name: str):
    return _load(metric_path(bench_dir, name), "bench_metric_", name)


def load_stage(bench_dir: str, name: str):
    return _load(stage_path(bench_dir, name), "bench_stage_", name)


def load(root: str) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: str, name: str, bench_dir: str = None) -> Cell:
    """The cell `name` of the manifest at root, its files read."""
    bench_dir = bench_dir or os.path.join(root, "benchmark")
    man = load(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name, chips=entry["chips"],
        config=_read(os.path.join(bench_dir, "configs",
                                  entry["config"] + ".json")),
        traffic=_read(os.path.join(bench_dir, "traffic",
                                   entry["traffic"] + ".json")),
        limits=_read(os.path.join(bench_dir, "limits", name + ".json")),
        end_to_end=[m for m in man["end_to_end"] if reports(m, name)],
        per_layer=[m for m in man["per_layer"] if reports(m, name)],
        bench_dir=bench_dir)


def problems(root: str, bench_dir: str = None) -> List[str]:
    """What in the manifest breaks the benchmark's naming rules or names a
    file that is not there (an empty list when all is well)."""
    bench_dir = bench_dir or os.path.join(root, "benchmark")
    man = load(root)
    out = []
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
             + [w["traffic"] for w in man["workloads"]]
             + [k for c in man["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    out += [f"bad unit {m['unit']!r}" for m in
            man["end_to_end"] + man["per_layer"] if not UNIT.match(m["unit"])]
    for c in man["configs"]:
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"missing {c['file']}")
    for w in man["workloads"]:
        for sub, stem in (("configs", w["config"]), ("traffic", w["traffic"]),
                          ("limits", w["name"])):
            if not os.path.exists(os.path.join(bench_dir, sub,
                                               stem + ".json")):
                out.append(f"{w['name']}: missing {sub}/{stem}.json")
        mix = os.path.join(bench_dir, "traffic", w["traffic"] + ".json")
        if os.path.exists(mix):
            stage = _read(mix).get("stage")
            if not isinstance(stage, str) or not NAME.match(stage):
                out.append(f"{w['name']}: bad stage {stage!r}")
            elif not os.path.exists(stage_path(bench_dir, stage)):
                out.append(f"{w['name']}: missing stages/{stage}.py")
            elif not all(hasattr(load_stage(bench_dir, stage), k)
                         for k in ("Driver", "numbers")):
                out.append(f"{w['name']}: stages/{stage}.py defines no "
                           f"Driver and numbers")
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        if not os.path.exists(metric_path(bench_dir, m["name"])):
            out.append(f"missing reader of {m['name']}")
            continue
        mod = load_metric(bench_dir, m["name"])
        for key in ("unit", "layer", "moves"):
            if getattr(mod, key.upper(), None) != m[key]:
                out.append(f"{m['name']}: {key} differs from its reader")
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves an unknown metric")
        for w in m.get("workloads", []):
            cells = [x for x in man["end_to_end"] if x["name"] == m["moves"]]
            if cells and not reports(cells[0], w):
                out.append(f"{m['name']}: {w} does not report {m['moves']}")
    return out
