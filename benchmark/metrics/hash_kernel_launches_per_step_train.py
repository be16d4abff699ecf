"""Launches of the hash-grid encoder's CUDA kernels (K11, forward and
backward) a training step: the program's launch counter
(`hash_encode_cuda.launches` in sanerf_hq_tpu_torch/ops/hashgrid.py) read
just before and just after the span slice (harness/spans.py), over the
slice's steps.  It shows that the main path ran K11.  Silent without a
card, and for a program without K11 (an earlier commit)."""
from benchmark.harness import spans

UNIT = "launches/step"
LAYER = "encoder"
MOVES = "train_rays_per_s"
KEY = "hash_kernel_launches"


def _kernel():
    try:
        from sanerf_hq_tpu_torch.ops import hashgrid
    except ImportError:
        return None
    kernel = getattr(hashgrid, "hash_encode_cuda", None)
    return kernel if hasattr(kernel, "launches") else None


def install(hooks):
    spans.install(hooks)
    if KEY in hooks.probes:
        return
    hooks.probes[KEY] = None
    kernel = _kernel()
    device = getattr(hooks.driver, "device", None)
    if kernel is None or getattr(device, "type", None) != "cuda":
        return
    # wrap the span slice's callback, wherever the readers put it
    for i, fn in enumerate(hooks.after):
        if getattr(fn, "__module__", None) == spans.__name__:
            def counted(fn=fn):
                before = kernel.launches
                fn()
                snap = hooks.probes.get(spans.KEY)
                if snap and snap["window"]["steps"]:
                    hooks.probes[KEY] = ((kernel.launches - before)
                                         / snap["window"]["steps"])
            hooks.after[i] = counted
            return


def read(rec):
    return rec["probes"].get(KEY)
