"""The field's hash encodes of one step of the cell, timed alone: the
points each encode sees are captured, by wrappers on the field's encoding
methods, in one untraced step after the traced slice; then each encode is
run by itself, forward and, where its table learns, backward, between
CUDA events (median of 10 after 2 warm-ups); the sum over the encodes."""
import statistics

import torch

UNIT = "ms"
LAYER = "encoder"
MOVES = "train_rays_per_s"
METHODS = {"common_forward": ("grid", "grid_spec"),
           "mask_features": ("m_grid", "m_spec")}


def install(hooks):
    model = hooks.driver.trainer.model
    if not hasattr(model, "prop_specs") or not torch.cuda.is_available():
        return
    from sanerf_hq_tpu_torch.ops.hashgrid import hash_encode

    seen = []

    def capture(name, table_of):
        inner = getattr(model, name)

        def wrapped(x, *a, **kw):
            if len(seen) < 16:
                table, spec = table_of(*a, **kw)
                if table is not None:
                    seen.append((name, table, spec, x.detach().clone()))
            return inner(x, *a, **kw)

        setattr(model, name, wrapped)

    for name, (t, s) in METHODS.items():
        capture(name, lambda *a, t=t, s=s, **kw: (getattr(model, t, None),
                                                  getattr(model, s, None)))
    capture("density", lambda proposal=-1, *a, **kw: (
        (getattr(model, f"prop_grid_{proposal}"), model.prop_specs[proposal])
        if proposal in (0, 1) else (None, None)))

    def time_encodes():
        for name in list(METHODS) + ["density"]:
            model.__dict__.pop(name, None)
        # one step's encodes: up to the first table encoded again
        n_step = next((i for i in range(1, len(seen))
                       if seen[i][1] is seen[0][1]), len(seen))
        total = 0.0
        for _, table, spec, x in seen[:n_step]:
            def run():
                t = table.detach().requires_grad_(table.requires_grad)
                y = hash_encode(t, x, spec, bound=model.grid_bound)
                if t.requires_grad:
                    y.backward(torch.ones_like(y))
            for _ in range(2):
                run()
            times = []
            for _ in range(10):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            total += statistics.median(times)
        hooks.probes["hash_encode_ms"] = total

    hooks.after.append(time_encodes)


def read(rec):
    return rec["probes"].get("hash_encode_ms")
