"""The readers of the program's spans and sync counter
(harness/spans.py): each gives its documented number from a hand-made
snapshot or profiler trace, and nothing from a CPU run's snapshot or
without one; the callback is registered once a run, and not at all for a
program without the tracer."""
import sys
import types
from types import SimpleNamespace

import pytest

from benchmark.harness import manifest, spans
from benchmark.tests.conftest import ROOT

READERS = ("hash_encode_step_ms", "host_syncs_per_step.train",
           "host_syncs_per_step.render")
REBUILD_READER = "error_map_rebuild_device_ms"
STEP = "sanerf.step"
FWD = STEP + "/sanerf.step.forward/sanerf.render"
REBUILD = "sanerf.rebuild"


def _span(each, syncs):
    """A snapshot's entry from its calls' [root, host ms, device ms]."""
    dev = [e[2] for e in each]
    return {"calls": len(each), "host_ms": sum(e[1] for e in each),
            "self_ms": 0.0,
            "device_ms": None if None in dev else sum(dev),
            "syncs": syncs, "each": each}


def _snapshot(cuda=True):
    """Three steps (roots 1, 3, 6, each after a batch) and a rebuild
    (root 5) of two views.  Encodes a step: 3 + 4 + 1 = 8, 10, 5 ms;
    syncs 2 a step, 1 in the rebuild, 3 outside."""
    d = (lambda v: v) if cuda else (lambda v: None)
    s = lambda n: n if cuda else None  # noqa: E731
    sp = {
        "sanerf.batch": _span([[0, 1, d(.1)], [2, 1, d(.1)],
                               [4, 1, d(.1)]], s(0)),
        STEP: _span([[1, 9, d(20)], [3, 9, d(20)], [6, 9, d(20)]], s(6)),
        FWD + "/sanerf.render.proposal/sanerf.encode": _span(
            [[1, 1, d(3)], [1, 1, d(4)], [3, 1, d(5)], [3, 1, d(5)],
             [6, 1, d(2)], [6, 1, d(2)]], s(0)),
        FWD + "/sanerf.render.final/sanerf.encode": _span(
            [[1, 1, d(1)], [3, 1, d(0)], [6, 1, d(1)]], s(0)),
        REBUILD: _span([[5, 100, d(90)]], s(0)),
        REBUILD + "/sanerf.rebuild.render": _span(
            [[5, 40, d(30)], [5, 60, d(50)]], s(1)),
        # encodes outside a step count in no step
        REBUILD + "/sanerf.rebuild.render/sanerf.view.chunk/sanerf.render/"
        "sanerf.render.final/sanerf.encode": _span([[5, 1, d(7)]], s(0)),
    }
    return {"device": "cuda" if cuda else "cpu", "spans": sp,
            "syncs_outside": s(3), "notes": [],
            "window": {"steps": 3, "seconds": 0.1}}


def _read(name, snap):
    mod = manifest.load_metric(f"{ROOT}/benchmark", name)
    return mod.read({"probes": {} if snap is None else {"spans": snap}})


@pytest.mark.parametrize("name,value", [
    ("hash_encode_step_ms", 8.0),  # median of 8, 10, 5
    ("host_syncs_per_step.train", (6 + 1 + 3) / 3),
    ("host_syncs_per_step.render", (6 + 1 + 3) / 3)])
def test_readers_from_a_hand_made_snapshot(name, value):
    assert _read(name, _snapshot()) == pytest.approx(value)
    # a CPU run's snapshot (no device times, no syncs), and none at all
    assert _read(name, _snapshot(cuda=False)) is None
    assert _read(name, None) is None


def test_a_step_with_no_encode_reads_zero():
    snap = _snapshot()
    snap["spans"][STEP]["each"].append([7, 9, 20.0])
    assert _read("hash_encode_step_ms", snap) == pytest.approx(6.5)
    # steps without any encode span (the MLP field): nothing
    assert _read("hash_encode_step_ms",
                 {**snap, "spans": {STEP: snap["spans"][STEP]}}) is None


def _hooks(traffic_steps=2):
    ran = []

    def window(seconds, steps=None):
        ran.append(steps)
        return {"steps": steps, "seconds": 0.01}

    cell = SimpleNamespace(traffic={"trace_steps": traffic_steps})
    return SimpleNamespace(driver=SimpleNamespace(cell=cell, window=window),
                           probes={}, after=[]), ran


def test_one_callback_a_run_however_many_readers_ask():
    hooks, ran = _hooks()
    for name in READERS:
        manifest.load_metric(f"{ROOT}/benchmark", name).install(hooks)
    assert len(hooks.after) == 1
    hooks.after[0]()
    assert ran == [2]  # the tracer on
    snap = hooks.probes["spans"]
    assert snap["window"] == {"steps": 2, "seconds": 0.01}
    assert snap["device"] in ("cpu", "cuda")
    from sanerf_hq_tpu_torch.utils import profiling
    assert profiling._tracer is None


def test_a_program_without_the_tracer_registers_nothing(monkeypatch):
    """An earlier commit's profiling module (no enable / snapshot): the
    readers stay silent and the run goes on."""
    import sanerf_hq_tpu_torch.utils as utils
    old = types.ModuleType("sanerf_hq_tpu_torch.utils.profiling")
    old.seed_everything = lambda *a, **k: None
    monkeypatch.setitem(sys.modules, "sanerf_hq_tpu_torch.utils.profiling",
                        old)
    monkeypatch.setattr(utils, "profiling", old, raising=False)
    hooks, ran = _hooks()
    spans.install(hooks)
    assert hooks.after == [] and hooks.probes == {"spans": None}
    for name in READERS:
        assert _read(name, hooks.probes["spans"]) is None


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


RENDER = "sanerf.rebuild.render"
# two views' render ranges (0-100, 200-300 us) and a score range between;
# kernels run after their launch, beyond their range's host end too
TRACE = [
    _x(REBUILD, "user_annotation", 0, 400),
    _x(RENDER, "user_annotation", 0, 100),
    _x(RENDER, "user_annotation", 200, 100),
    _x("sanerf.rebuild.score", "user_annotation", 120, 60),
    _x(RENDER, "gpu_user_annotation", 0, 400),  # the device's copy: no range
    _x("cudaLaunchKernel", "cuda_runtime", 10, 2, 1),
    _x("cuLaunchKernel", "cuda_driver", 20, 2, 2),
    _x("cudaLaunchKernel", "cuda_runtime", 150, 2, 3),  # in the score
    _x("cudaLaunchKernel", "cuda_runtime", 210, 2, 4),
    _x("cudaMemcpyAsync", "cuda_runtime", 250, 2, 5),
    _x("k1", "kernel", 30, 40, 1),
    _x("k2", "kernel", 60, 30, 2),      # overlaps k1: the union, 30-90
    _x("k3", "kernel", 155, 20, 3),     # launched outside: left out
    _x("k4", "kernel", 290, 50, 4),     # runs past the range: counted
    _x("copy", "gpu_memcpy", 340, 5, 5),  # a copy, not a kernel
    _x("aten::add", "cpu_op", 10, 5),
]


def test_kernel_ms_in_ranges():
    assert spans.kernel_ms_in_ranges(TRACE, RENDER) == pytest.approx(
        (60 + 50) * 1e-3)
    # a program without the span: nothing; ranges with no kernel: 0
    assert spans.kernel_ms_in_ranges(TRACE, "sanerf.absent") is None
    assert spans.kernel_ms_in_ranges(
        [e for e in TRACE if e["cat"] != "kernel"], RENDER) == 0.0


def test_the_rebuild_reader():
    mod = manifest.load_metric(f"{ROOT}/benchmark", REBUILD_READER)
    assert mod.read({"probes": {REBUILD_READER: 80.0}}) == 80.0
    assert mod.read({"probes": {}}) is None
    # a driver without a rebuild (stage 1, render), or no CUDA device:
    # no profiled rebuild
    hooks, _ = _hooks()
    mod.install(hooks)
    assert hooks.after == []
