"""The port's tracer (named spans and a host-sync counter at the
boundaries where the work happens: the loop, the step, the renderer, the
view, the encoder) and seeding.

`span(name)` is a context manager placed in the program's functions.

  - Off (the default) and no profiler recording: one check, then a
    shared no-op context; nothing is allocated or recorded.
  - A `torch.profiler` recording (the tracer on or off): the span is a
    `record_function` range, so the profiler's trace (and, under
    `torch.autograd.profiler.emit_nvtx`, an Nsight Systems trace) carries
    the program's phases on the device trace's clock beside its kernels.
  - The tracer on (`enable`): each span also keeps a record of its name,
    its parent and its host start and end; with a CUDA device, a CUDA
    event pair on the current stream around it, resolved only by
    `snapshot()`, after one synchronize, and the count of synchronising
    CUDA calls (`torch.cuda.set_sync_debug_mode("warn")`, whose warnings
    are counted and kept out of the log) made while it is the innermost
    open span; syncs outside any span are counted apart.

The tracer keeps the records of one thread's nesting: turn it on around
single-threaded work (a training run, a render loop).

    from sanerf_hq_tpu_torch.utils import profiling
    profiling.enable()
    ...                                # train or render
    profiling.write("spans.json")      # and spans.trace.json
    profiling.disable()
"""
from __future__ import annotations

import json
import os
import random
import time
import warnings
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device

_profiler_recording = torch._C._autograd._profiler_enabled
_OFF = nullcontext()
_SYNC_WARNING = "synchronizing CUDA operation"
_tracer: Optional["Tracer"] = None


class _Record:
    """One call of a span: its path from the outermost open span, the
    call number of that outermost span (`root`), host times in ns, the
    CUDA event pairs that time it on the device, its syncs."""

    __slots__ = ("path", "root", "t0", "t1", "child_ns", "events", "syncs")

    def __init__(self, path: str, root: int):
        self.path, self.root = path, root
        self.t0 = time.perf_counter_ns()
        self.t1 = None
        self.child_ns = 0
        self.events: List[list] = []
        self.syncs = 0


class _Profiled:
    """A `record_function` range; yields no record."""

    __slots__ = ("rf",)

    def __init__(self, name: str):
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)


class _Span:
    __slots__ = ("tracer", "name", "rec", "rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name, self.rf = tracer, name, None

    def __enter__(self) -> _Record:
        t = self.tracer
        if _profiler_recording():
            self.rf = _Profiled(self.name)
            self.rf.__enter__()
        if t.stack:
            parent = t.stack[-1]
            rec = _Record(parent.path + "/" + self.name, parent.root)
        else:
            rec = _Record(self.name, t.roots)
            t.roots += 1
        if t.cuda:
            rec.events.append([_recorded_event(), None])
        t.stack.append(rec)
        t.records.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        t, rec = self.tracer, self.rec
        if t.cuda:
            rec.events[0][1] = _recorded_event()
        rec.t1 = time.perf_counter_ns()
        t.stack.pop()
        if t.stack:
            t.stack[-1].child_ns += rec.t1 - rec.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)


def _recorded_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Tracer:
    """The records and sync counts of one `enable` ... `disable` (see
    the module's docstring)."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.records: List[_Record] = []
        self.stack: List[_Record] = []
        self.roots = 0
        self.syncs_outside = 0
        self.notes: List[str] = [] if self.cuda else [
            "device times not measured and syncs not counted: no CUDA device"]
        self._saved = None

    def start(self):
        if self.cuda:
            catcher = warnings.catch_warnings()
            catcher.__enter__()
            warnings.filterwarnings("always", message=".*" + _SYNC_WARNING)
            warnings.filterwarnings(
                "ignore", message="Synchronization debug mode is a prototype")
            shown = warnings.showwarning

            def on_warning(message, category, filename, lineno, file=None,
                           line=None):
                if _SYNC_WARNING not in str(message):
                    return shown(message, category, filename, lineno, file,
                                 line)
                if self.stack:
                    self.stack[-1].syncs += 1
                else:
                    self.syncs_outside += 1

            warnings.showwarning = on_warning
            self._saved = (catcher, torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self):
        if self._saved is not None:
            catcher, mode = self._saved
            torch.cuda.set_sync_debug_mode(mode)
            catcher.__exit__(None, None, None)
            self._saved = None

    def snapshot(self) -> dict:
        """For each span path: calls, host ms (total, and self: less its
        children's), device ms (the event pairs'), syncs and `each` call's
        [root, host ms, device ms]; the syncs outside any span.  Device ms
        and syncs are None without a CUDA device."""
        if self.cuda:
            torch.cuda.synchronize()  # counts no sync
        spans: Dict[str, dict] = {}
        for rec in self.records:
            if rec.t1 is None:  # still open
                continue
            s = spans.setdefault(rec.path, {
                "calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                "device_ms": 0.0 if self.cuda else None,
                "syncs": 0 if self.cuda else None, "each": []})
            host = (rec.t1 - rec.t0) * 1e-6
            dev = None
            if self.cuda:
                dev = sum(a.elapsed_time(b) for a, b in rec.events
                          if b is not None)
                s["device_ms"] += dev
            s["calls"] += 1
            s["host_ms"] += host
            s["self_ms"] += host - rec.child_ns * 1e-6
            if self.cuda:
                s["syncs"] += rec.syncs
            s["each"].append([rec.root, host, dev])
        return {"device": "cuda" if self.cuda else "cpu",
                "spans": spans,
                "syncs_outside": self.syncs_outside if self.cuda else None,
                "notes": list(self.notes)}

    def chrome_events(self) -> List[dict]:
        """The closed records as Chrome-trace complete events (ts and dur
        in microseconds from the first record)."""
        done = [r for r in self.records if r.t1 is not None]
        if not done:
            return []
        base = min(r.t0 for r in done)
        return [{"name": r.path.rsplit("/", 1)[-1], "cat": "sanerf",
                 "ph": "X", "pid": 0, "tid": 0,
                 "ts": (r.t0 - base) / 1e3, "dur": (r.t1 - r.t0) / 1e3,
                 "args": {"path": r.path, "syncs": r.syncs}}
                for r in done]


def span(name: str):
    """A span of the program named `name` (see the module's docstring);
    `with span(name) as rec:` gives the record with the tracer on, else
    None."""
    if _tracer is None:
        return _Profiled(name) if _profiler_recording() else _OFF
    return _Span(_tracer, name)


def time_backward(rec: Optional[_Record], output, leaf):
    """With a CUDA device, add to the span record `rec` the device time
    from autograd's computing `output`'s gradient to its accumulating
    `leaf`'s: the backward of what the span computed from the leaf, and
    any other work autograd runs between the two.  Nothing when rec is
    None, without a CUDA device, or where no gradient reaches the leaf."""
    if (rec is None or _tracer is None or not _tracer.cuda
            or not output.requires_grad or not leaf.requires_grad
            or not leaf.is_leaf):
        return

    def on_output_grad(_):
        start = _recorded_event()

        def on_leaf_grad(_):
            rec.events.append([start, _recorded_event()])
            handle.remove()

        handle = leaf.register_post_accumulate_grad_hook(on_leaf_grad)

    output.register_hook(on_output_grad)


def enable() -> Tracer:
    """Turn the tracer on, from empty (a tracer already on is stopped and
    replaced): it times each span on the host and, with a CUDA device, on
    the device, and counts synchronising CUDA calls; without one the
    snapshot notes that these were not measured."""
    global _tracer
    disable()
    _tracer = Tracer()
    _tracer.start()
    return _tracer


def disable() -> Optional[Tracer]:
    """Turn the tracer off, put back the sync debug mode and the warning
    filters; returns the tracer that was on (its records kept)."""
    global _tracer
    t, _tracer = _tracer, None
    if t is not None:
        t.stop()
    return t


def snapshot() -> dict:
    """The tracer's snapshot (Tracer.snapshot); raises when it is off."""
    if _tracer is None:
        raise RuntimeError("the tracer is off: profiling.enable() first")
    return _tracer.snapshot()


def write(path: str) -> str:
    """Write the snapshot as JSON to `path` and the span records as a
    Chrome trace (chrome://tracing, Perfetto) beside it, at
    `<path without .json>.trace.json`; returns the trace's path."""
    snap = snapshot()
    trace_path = (path[:-5] if path.endswith(".json") else path) \
        + ".trace.json"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(snap, f, indent=1)
    with open(trace_path, "w") as f:
        json.dump({"traceEvents": _tracer.chrome_events(),
                   "displayTimeUnit": "ms"}, f)
    return trace_path


def seed_everything(seed: int, device=None) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a
    torch.Generator on `device` (default the card) seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    gen = torch.Generator(resolve_device(device))
    gen.manual_seed(seed)
    return gen
