"""The SAM cache cell at tiny widths on the CPU: the tiny copy of the
benchmark with a cell of the `sam_cache` stage added by files and entries
alone (configs/tiny-sam.json, traffic/c.json, limits/tiny-sam.c.json),
the tiny ViT registered under vit_h's name (the CLI's --sam_model_type
takes only the published names).  Its line, its check against the plain
reference (benchmark/reference/sam.py), its faults and control, its
span readers from a snapshot of the SAM view's span tree, and its work
counts at ViT-H's widths against the counts by hand."""
import contextlib
import io
import json
import os
import time

import pytest
import torch

from benchmark.harness import manifest
from benchmark.harness.main import main
from benchmark.tests import tiny
from benchmark.tests.conftest import ROOT

CELL = "tiny-sam.c"
# image 112 in 16x16 patches: a 7x7 grid, padded to 8x8 by windows of 4
TINY_VIT = dict(embed_dim=32, depth=4, num_heads=2, window_size=4,
                global_attn_indexes=(1, 3))
SAM = {"img_size": 112, "patch_size": 16, "embed_dim": 32, "depth": 4,
       "num_heads": 2, "mlp_ratio": 4.0, "out_chans": 256,
       "window_size": 4, "global_attn_indexes": [1, 3]}
LIMITS = {"input_levels": 1.0, "feat_rel": 1e-4, "interm_rel": 1e-4,
          "image_rmse": 1e-3}


@pytest.fixture(scope="module")
def sam_root(tmp_path_factory):
    """The tiny copy with the SAM cell added."""
    root = tiny.make(str(tmp_path_factory.mktemp("sam")))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "sam-vit-h.json")) as f:
        cfg = json.load(f)
    cfg["field"]["num_steps"] = tiny.STEPS
    cfg["scene"] = tiny.SCENE
    cfg["sam"] = SAM
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "cache-1024.json")) as f:
        mix = json.load(f)
    mix["flags"]["max_ray_batch"] = 256
    mix.update(warmup_views=1, photos=1, check={"views": 2, "within": 3},
               trace_steps=2)
    for rel, obj in (("configs/tiny-sam.json", cfg), ("traffic/c.json", mix),
                     (f"limits/{CELL}.json", LIMITS)):
        with open(os.path.join(bench, rel), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "tiny-sam", "source": "tiny",
                           "file": "benchmark/configs/tiny-sam.json",
                           "reduced": [], "why": "tiny"})
    man["workloads"].append({"name": CELL, "config": "tiny-sam",
                             "traffic": "c", "chips": 1, "why": "tiny"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


@pytest.fixture
def tiny_vit(monkeypatch):
    from sanerf_hq_tpu_torch.sam import build
    monkeypatch.setitem(build._CONFIGS, "vit_h", lambda: dict(TINY_VIT))


def _run(root, *flags, seconds=0.5):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--workload", CELL, "--seed", "2147483659", "--seconds",
                   str(seconds), *flags], time.time(),
                  device=torch.device("cpu"), root=root,
                  bench_dir=os.path.join(root, "benchmark"))
    lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    return rc, (json.loads(lines[-1]) if rc == 0 else None)


def test_manifests_have_no_problems(sam_root):
    assert manifest.problems(ROOT) == []
    assert manifest.problems(sam_root) == []
    cell = manifest.cell(ROOT, "sam-vit-h.cache-1024")
    assert cell.stage_module().Driver.__module__.endswith("sam_cache")
    assert {m["name"] for m in cell.end_to_end} == {"view_ms.p95",
                                                    "setup_s"}


@pytest.mark.parametrize("trace,metrics", [
    ("0", {"view_ms.p95", "setup_s"}),
    # the span readers need the card's device times (test below)
    ("1", {"sam_mfu", "device_idle_pct.sam"})])
def test_line_and_check(sam_root, tiny_vit, trace, metrics):
    rc, out = _run(sam_root, "--trace", trace)
    assert rc == 0
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == metrics
    assert set(out["check"]) == set(LIMITS)
    # one level of 255 at most between the two resizes
    assert out["check"]["input_levels"]["value"] <= 1.0
    assert out["check"]["feat_rel"]["value"] < 1e-5


@pytest.mark.parametrize("flag", [("--fault", "half"),
                                  ("--fault", "altered"), ("--control",)])
def test_faults_and_control_are_not_correct(sam_root, tiny_vit, flag):
    rc, out = _run(sam_root, *flag)
    assert rc == 0
    assert out["correct"] is False
    assert out["check"]["feat_rel"]["value"] > LIMITS["feat_rel"]


def test_window_records_latency(sam_root, tiny_vit, tmp_path):
    cell = manifest.cell(sam_root, CELL, os.path.join(sam_root,
                                                      "benchmark"))
    stage = cell.stage_module()
    scene = stage.scene(str(tmp_path), cell)
    driver = stage.Driver(cell, 7, torch.device("cpu"), str(tmp_path),
                          scene)
    driver.setup()
    win = driver.window(0, steps=3)
    assert win["views"] == win["steps"] == len(win["latency_s"]) == 3
    assert set(driver.answers) == driver.keep and len(driver.photos) == 1
    a = driver.answers[min(driver.keep)]
    assert a["features"].shape == (7, 7, 256)
    assert tuple(a["interm"].shape) == (7, 7, 32)
    assert a["image"].shape == (24 * 32, 3)


VIEW = "sanerf.sam.view"
ENC = VIEW + "/sanerf.sam.encode"


def _snapshot():
    """Two cache views (roots 0, 1): encodes of 10 and 12 ms device time,
    of which windowed blocks 2 + 3 and 4 + 4, global 5 and 6 ms; 3 syncs
    a view in spans and 1 outside."""
    def sp(each, syncs):
        return {"calls": len(each), "host_ms": 1.0, "self_ms": 0.0,
                "device_ms": sum(e[2] for e in each), "syncs": syncs,
                "each": each}
    return {"device": "cuda", "syncs_outside": 1, "notes": [],
            "window": {"steps": 2, "seconds": 0.5},
            "spans": {
                VIEW: sp([[0, 20, 15.0], [1, 22, 17.0]], 0),
                VIEW + "/sanerf.view": sp([[0, 3, 2.0], [1, 3, 2.0]], 2),
                VIEW + "/sanerf.sam.preprocess": sp([[0, 1, .5],
                                                     [1, 1, .5]], 0),
                ENC: sp([[0, 11, 10.0], [1, 13, 12.0]], 0),
                ENC + "/sanerf.sam.encode.window": sp(
                    [[0, 1, 2.0], [0, 1, 3.0], [1, 1, 4.0], [1, 1, 4.0]], 0),
                ENC + "/sanerf.sam.encode.global": sp([[0, 1, 5.0],
                                                       [1, 1, 6.0]], 0),
                VIEW + "/sanerf.sam.readback": sp([[0, 1, .1],
                                                   [1, 1, .1]], 4)}}


@pytest.mark.parametrize("name,value", [
    ("sam_encode_ms", 11.0), ("sam_window_blocks_ms", 6.5),
    ("sam_global_blocks_ms", 5.5),
    ("host_syncs_per_step.sam", (2 + 4 + 1) / 2)])
def test_span_readers(name, value):
    mod = manifest.load_metric(os.path.join(ROOT, "benchmark"), name)
    assert mod.read({"probes": {"spans": _snapshot()}}) == pytest.approx(
        value)
    assert mod.read({"probes": {}}) is None


def test_vit_h_counts_by_hand():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "sam-vit-h.json")) as f:
        c = manifest.load_stage(os.path.join(ROOT, "benchmark"),
                                "sam_cache").SamCounts(json.load(f)["sam"])
    m = c.encode_macs()
    C, N, P = 1280, 64 * 64, 70 * 70  # width, tokens, padded tokens
    assert m["window_linears"] == 28 * (4 * P * C * C + 8 * N * C * C)
    assert m["global_attention"] == 4 * 16 * (2 * N * N * 80
                                              + 2 * N * 64 * 80)
    assert m["window_attention"] == 28 * 25 * 16 * (2 * 196 * 196 * 80
                                                    + 2 * 196 * 14 * 80)
    # 2.98 T multiply-adds, 5.96 TFLOP an encode
    assert c.encode_flops() == pytest.approx(5.96e12, rel=2e-3)
    # segment-anything's ViT-H image encoder: 637,026,048 parameters
    assert c.encode_params() == 637026048
