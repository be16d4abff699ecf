"""The port's tracer (`utils/profiling.py`) and the spans placed in the
program: nothing recorded while it is off, paths, parents and self time,
a new tracer starting from empty, the JSON and Chrome-trace export, the spans inside a
`torch.profiler` trace with the tracer off, and the span trees of a
stage-1 step, a mask step with an error-map rebuild, a view and a
feature-cache view through SAM's encoder (PERF.md §3 lists them), whose
features the tracer leaves bit for bit.  The card-marked tests (device events, the sync counter,
the encoder's backward) run on the card:
python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""
import json
import time
import warnings

import numpy as np
import pytest
import torch

from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.provider import Scene
from sanerf_hq_tpu_torch.data.sampler import sample_mask_batch
from sanerf_hq_tpu_torch.data.synthetic import make_synthetic_dataset
from sanerf_hq_tpu_torch.models import SANeRFField
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode
from sanerf_hq_tpu_torch.sam import SamPredictor, build_sam
from sanerf_hq_tpu_torch.sam import build as sam_build
from sanerf_hq_tpu_torch.train.stages import encode_view, update_error_map
from sanerf_hq_tpu_torch.train.steps import make_mask_train_step
from sanerf_hq_tpu_torch.train.trainer import Trainer
from sanerf_hq_tpu_torch.utils import profiling

MAIN = dict(num_levels=3, level_dim=2, base_resolution=8,
            log2_hashmap_size=10, desired_resolution=32)
PROP = dict(num_levels=2, level_dim=2, base_resolution=8,
            log2_hashmap_size=9, desired_resolution=16)
HW = 16
CFG = dict(num_steps=(8, 4, 2), num_rays=64, adaptive_num_rays=False,
           iters=10, bound=4.0, min_near=0.05, max_ray_batch=128,
           error_map_size=8, local_sample_patch_size=4, num_local_sample=2,
           ray_pair_rgb_loss_weight=1.0, ray_pair_rgb_iter=1,
           device="cpu")

RENDER = ["sanerf.render", "sanerf.render/sanerf.render.proposal",
          "sanerf.render/sanerf.render.proposal/sanerf.encode",
          "sanerf.render/sanerf.render.final",
          "sanerf.render/sanerf.render.final/sanerf.encode"]
FWD = "sanerf.step/sanerf.step.forward/"
STEP = (["sanerf.batch", "sanerf.step", "sanerf.step/sanerf.step.forward",
         "sanerf.step/sanerf.step.backward",
         "sanerf.step/sanerf.step.optimizer"] + [FWD + p for p in RENDER])
CHUNK = "sanerf.view.chunk"
REBUILD = (["sanerf.rebuild", "sanerf.rebuild/sanerf.rebuild.render",
            "sanerf.rebuild/sanerf.rebuild.score",
            "sanerf.rebuild/sanerf.rebuild.render/" + CHUNK]
           + ["sanerf.rebuild/sanerf.rebuild.render/" + CHUNK + "/" + p
              for p in RENDER])
VIEW = (["sanerf.view", "sanerf.view/sanerf.view.rays",
         "sanerf.view/sanerf.view.readback", "sanerf.view/" + CHUNK]
        + ["sanerf.view/" + CHUNK + "/" + p for p in RENDER])
SAM_VIEW = "sanerf.sam.view"
ENCODE = SAM_VIEW + "/sanerf.sam.encode"
SAM = ([SAM_VIEW, SAM_VIEW + "/sanerf.sam.preprocess", ENCODE,
        SAM_VIEW + "/sanerf.sam.readback"]
       + [ENCODE + "/sanerf.sam.encode." + p
          for p in ("patch", "window", "global", "neck")]
       + [SAM_VIEW + "/" + p for p in VIEW])
# ViT-H's depth and global blocks at a tiny width: a 5x5 grid (image 80)
# in windows of 4, padded to 8x8
SAM_VIT = dict(embed_dim=16, depth=32, num_heads=2, window_size=4,
               global_attn_indexes=(7, 15, 23, 31))
# the span tree of each piece of work, as PERF.md §3 has it
TREES = {"stage1_step": STEP + ["sanerf.ema"],
         "mask_step_and_rebuild": STEP + REBUILD,
         "view": VIEW, "sam_view": SAM}


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A trainer over a tiny hash-grid field with an object field, its
    scene with object masks, and the three pieces of work of TREES."""
    s = make_synthetic_dataset(n_views=3, H=HW, W=HW)
    rng = np.random.default_rng(0)
    masks = rng.integers(0, 2, (3, HW, HW))
    scene = Scene(images=s["images"], poses=s["poses"],
                  intrinsics=np.tile(s["intrinsics"], (3, 1)), H=HW, W=HW,
                  img_names=np.array(["a", "b", "c"]), masks=masks)
    cfg = Config(**CFG)
    field = SANeRFField(grid_bound=cfg.grid_bound, with_mask=True,
                        main_spec=HashGridSpec(**MAIN),
                        feat_spec=HashGridSpec(**MAIN),
                        prop_spec_0=HashGridSpec(**PROP),
                        prop_spec_1=HashGridSpec(**PROP), device="cpu")
    tr = Trainer("t", cfg, field, str(tmp_path_factory.mktemp("trace")),
                 resume=False)
    tr.prepare_training(scene)
    mask_step = make_mask_train_step(field, cfg)
    gen = torch.Generator().manual_seed(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    error_map = torch.ones((3, 64))

    def stage1_step():
        tr.train_one_step()
        tr.state.update_ema()

    def mask_step_and_rebuild():
        batch = sample_mask_batch(
            gen, torch.as_tensor(masks), t(scene.poses), t(s["intrinsics"]),
            error_map, cfg.num_rays, cfg.num_local_sample,
            cfg.local_sample_patch_size, HW, HW, cfg.error_map_size)
        mask_step(tr.state, batch, gen, error_map)
        update_error_map(tr, masks, scene.poses, s["intrinsics"], HW, HW)

    def view():
        tr.render_view(scene.poses[0], s["intrinsics"], HW, HW)

    sam_build._CONFIGS["vit_trace"] = lambda: dict(SAM_VIT)
    try:
        pred = SamPredictor(build_sam("vit_trace", img_size=80, seed=0,
                                      device="cpu"), img_size=80)
    finally:
        del sam_build._CONFIGS["vit_trace"]

    def sam_view():
        return encode_view(tr, pred, scene.poses[0], s["intrinsics"], HW,
                           HW)

    return {"stage1_step": stage1_step,
            "mask_step_and_rebuild": mask_step_and_rebuild, "view": view,
            "sam_view": sam_view}


def test_off_records_nothing(work, monkeypatch):
    """Tracer off and no profiler recording: a stage-1 step makes no span
    record, no CUDA event and no record_function range."""
    made = []
    for name in ("_Span", "_Profiled", "_recorded_event"):
        inner = getattr(profiling, name)
        monkeypatch.setattr(profiling, name, lambda *a, _n=name, _i=inner:
                            made.append(_n) or _i(*a))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: made.append("record_function"))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append("Event"))
    assert profiling.span("sanerf.step") is profiling.span("sanerf.view")
    work["stage1_step"]()
    assert made == []
    assert profiling.disable() is None


def test_nesting_parents_and_self_time():
    profiling.enable()
    with profiling.span("a") as rec:
        time.sleep(0.004)
        for _ in range(2):
            with profiling.span("b"):
                time.sleep(0.003)
                with profiling.span("c"):
                    time.sleep(0.001)
    with profiling.span("a"):
        pass
    assert rec.path == "a" and rec.root == 0
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert set(spans) == {"a", "a/b", "a/b/c"}
    assert [spans[p]["calls"] for p in ("a", "a/b", "a/b/c")] == [2, 2, 2]
    a, b, c = (spans[p] for p in ("a", "a/b", "a/b/c"))
    # self: a span's time less its direct children's
    np.testing.assert_allclose(a["self_ms"], a["host_ms"] - b["host_ms"],
                               rtol=1e-9)
    np.testing.assert_allclose(b["self_ms"], b["host_ms"] - c["host_ms"],
                               rtol=1e-9)
    assert c["self_ms"] == pytest.approx(c["host_ms"])
    assert a["each"][0][1] >= 4 + 2 * 3 + 2 * 1
    assert b["self_ms"] >= 2 * 3 and c["host_ms"] >= 2 * 1
    # each call's root: the call number of its outermost span
    assert [e[0] for e in a["each"]] == [0, 1]
    assert [e[0] for e in c["each"]] == [0, 0]


def test_enable_starts_from_empty_and_disable_keeps_the_records():
    with profiling.span("before"):  # off: nothing
        pass
    first = profiling.enable()
    with profiling.span("a"):
        pass
    second = profiling.enable()  # the first stopped and replaced
    assert second is not first and profiling._tracer is second
    assert set(profiling.snapshot()["spans"]) == set()
    with profiling.span("b"):
        pass
    assert profiling.disable() is second
    assert [r.path for r in first.records] == ["a"]
    assert [r.path for r in second.records] == ["b"]
    with pytest.raises(RuntimeError):
        profiling.snapshot()


def test_write_gives_json_and_a_chrome_trace(tmp_path):
    profiling.enable()
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    trace = profiling.write(str(tmp_path / "out" / "spans.json"))
    assert trace == str(tmp_path / "out" / "spans.trace.json")
    with open(tmp_path / "out" / "spans.json") as f:
        snap = json.load(f)
    assert set(snap["spans"]) == {"outer", "outer/inner"}
    assert snap["spans"]["outer/inner"]["calls"] == 1
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events] == ["outer", "inner"]
    outer, inner = events
    assert all(e["ph"] == "X" for e in events)
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert inner["args"]["path"] == "outer/inner"


def test_profiler_trace_holds_the_step_with_the_tracer_off(work, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work["stage1_step"]()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    for name in ("sanerf.batch", "sanerf.step", "sanerf.step.forward",
                 "sanerf.step.backward", "sanerf.step.optimizer",
                 "sanerf.render", "sanerf.render.proposal",
                 "sanerf.render.final", "sanerf.encode", "sanerf.ema"):
        assert name in by, name
    assert len(by["sanerf.step"]) == 1
    assert len(by["sanerf.render.proposal"]) == 2
    assert len(by["sanerf.encode"]) == 3
    step = by["sanerf.step"][0]
    for e in by["sanerf.step.forward"] + by["sanerf.encode"]:
        assert step["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= step["ts"] + step["dur"]
    assert profiling._tracer is None


@pytest.mark.parametrize("piece", sorted(TREES))
def test_span_tree(work, piece):
    work[piece]()  # warm
    profiling.enable()
    work[piece]()
    snap = profiling.snapshot()
    assert sorted(snap["spans"]) == sorted(TREES[piece])
    spans = snap["spans"]
    # on the CPU: no device times, no syncs, and the snapshot says so
    assert all(s["device_ms"] is None and s["syncs"] is None
               for s in spans.values())
    assert snap["syncs_outside"] is None and len(snap["notes"]) == 1
    if piece == "view":
        assert spans["sanerf.view/" + CHUNK]["calls"] == 2  # 256 / 128 rays
    if piece == "sam_view":
        assert [spans[ENCODE + "/sanerf.sam.encode." + p]["calls"]
                for p in ("patch", "window", "global", "neck")] == [1, 28,
                                                                    4, 1]
    if piece == "mask_step_and_rebuild":
        assert spans["sanerf.rebuild/sanerf.rebuild.render"]["calls"] == 3
        assert spans[FWD + "sanerf.render/sanerf.render.final/"
                     "sanerf.encode"]["calls"] == 2  # grid and m_grid
    for path, s in spans.items():
        kids = [k for k in spans if k.startswith(path + "/")
                and "/" not in k[len(path) + 1:]]
        np.testing.assert_allclose(
            s["self_ms"], s["host_ms"] - sum(spans[k]["host_ms"]
                                             for k in kids), atol=1e-6)


def test_sam_view_is_bit_identical_with_the_tracer_on(work):
    """The spans change no value: a cache view's features with the tracer
    off, on, and off again are equal bit for bit."""
    off = work["sam_view"]()
    profiling.enable()
    on = work["sam_view"]()
    assert profiling.snapshot()["spans"][SAM_VIEW]["calls"] == 1
    profiling.disable()
    assert off.shape == (5, 5, 256) and off.dtype == np.float32
    assert np.array_equal(off.view(np.uint32), on.view(np.uint32))
    assert np.array_equal(off.view(np.uint32),
                          work["sam_view"]().view(np.uint32))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_device_events_are_resolved():
    _card()
    x = torch.randn(2048, 2048, device="cuda")
    profiling.enable()
    with profiling.span("mm"):
        for _ in range(4):
            x = x @ x * 1e-3
    with profiling.span("idle"):
        pass
    snap = profiling.snapshot()["spans"]
    assert snap["mm"]["device_ms"] > snap["idle"]["device_ms"] >= 0
    assert snap["mm"]["each"][0][2] == snap["mm"]["device_ms"]


@pytest.mark.gpu
def test_sync_counter_on_the_card():
    _card()
    y = torch.ones(8, device="cuda")
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        profiling.enable()
        with profiling.span("in"):
            x = torch.tensor([1.0, 2.0, 3.0], device="cuda")
        with profiling.span("out"):
            x.cpu()
        with profiling.span("chain"):
            z = (y * 2 + 1).exp().sum(0, keepdim=True)
            z = torch.where(z > 0, z, -z).sqrt()
        y.sum().item()
        snap = profiling.snapshot()
        assert torch.cuda.get_sync_debug_mode() == 1
        profiling.disable()
    assert torch.cuda.get_sync_debug_mode() == 0
    spans = snap["spans"]
    assert (spans["in"]["syncs"], spans["out"]["syncs"],
            spans["chain"]["syncs"]) == (1, 1, 0)
    assert snap["syncs_outside"] == 1
    # the warnings were counted, not shown
    leaked = [(str(w.message), w.filename, w.lineno) for w in shown
              if "synchronizing" in str(w.message)]
    assert not leaked, leaked
    with torch.autograd.profiler.emit_nvtx():
        assert profiling._profiler_recording()  # Nsight Systems ranges


@pytest.mark.gpu
def test_encode_span_times_the_backward_on_the_card():
    """A learning table's encode span holds a second event pair, from the
    output's gradient to the table's accumulated gradient; a frozen
    table's holds the forward's alone; no hook is left on the table."""
    _card()
    spec = HashGridSpec(**MAIN)
    table = torch.nn.Parameter(torch.randn(spec.total_params, 2,
                                           device="cuda") * 0.1)
    x = torch.rand(65536, 3, device="cuda") * 2 - 1
    hash_encode(table, x, spec).sum().backward()  # warm
    table.grad = None
    tracer = profiling.enable()
    hash_encode(table.detach(), x, spec)  # no table grad: forward only
    out = hash_encode(table, x, spec)
    (out * out).sum().backward()
    snap = profiling.snapshot()["spans"]["sanerf.encode"]
    frozen, learning = tracer.records
    assert [len(frozen.events), len(learning.events)] == [1, 2]
    pairs = [a.elapsed_time(b) for a, b in learning.events]
    assert snap["calls"] == 2 and min(pairs) > 0
    assert snap["each"][1][2] == pytest.approx(sum(pairs))
    assert not table._post_accumulate_grad_hooks
