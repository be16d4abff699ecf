"""The readings the limits of `correct` are set from, many seeds in one
process (the benchmark's runs do not run this):

  python3 benchmark/readings.py --workload <cell> --seeds 1,2,3
        [--control] [--fault frozen|half|altered] [--window 0]

For each seed: the cell's set-up (scene, parameters, the program's first
steps or sampled answers), then the numbers of the check: the program's
against the reference's, and with --control also the reference at the
configuration's control precision against it.  One JSON line a seed."""
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import check, manifest  # noqa: E402
from benchmark.reference import steps as ref_steps  # noqa: E402
from benchmark.reference.common import Draws  # noqa: E402


def _worst(gaps, k):
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:k]


def _pair_margins(draws, rgb, probs, incoherent, cfg):
    """How near the ray-pair loss's three switches of one call lie to
    flipping: a colour distance to its threshold, an anchor's two most
    likely classes, a ray's coherence to 0.8 (the draw replayed from a
    copy of the generator)."""
    P, S, _ = rgb.shape
    gate = 1.0 - incoherent
    weights = (gate > 0.8).float()
    weights = torch.where(weights.sum(-1, keepdim=True) == 0, 1.0, weights)
    copy = Draws(draws.gen.get_state(), draws.device)
    e = copy.exponential((P, S))
    idx = torch.topk(torch.log(weights.clamp_min(1e-12)) - torch.log(e),
                     cfg["ray_pair_num_sample"], dim=-1).indices
    rgb_s = torch.gather(rgb, 1, idx[..., None].expand(-1, -1, 3))
    dist = torch.linalg.norm(rgb[:, None] - rgb_s[:, :, None], dim=-1)
    top2 = torch.gather(probs.detach(), 1, idx[..., None].expand(
        -1, -1, probs.shape[-1])).topk(2, dim=-1).values
    return {"colour": float((dist - cfg["ray_pair_threshold"]).abs().min()),
            "anchor_class": float((top2[..., 0] - top2[..., 1]).min()),
            "coherence": float((gate - 0.8).abs().min())}


def look_later(stage, d, stated):
    """The later steps' widest leaves, and the ray-pair switches' margins
    at the first later step, the one whose gradient is compared."""
    seen = []
    plain = ref_steps.ray_pair_loss

    def probe(draws, rgb, probs, incoherent, cfg):
        seen.append(_pair_margins(draws, rgb, probs, incoherent, cfg))
        return plain(draws, rgb, probs, incoherent, cfg)

    ref_steps.ray_pair_loss = probe
    try:
        ref = stage.reference(d, stated, later=True, follow=d.later["maps"])
    finally:
        ref_steps.ray_pair_loss = plain
    grads, changes = check.leaf_gaps(d.later, ref)
    m0 = {n: float(torch.linalg.norm(m.double()))
          for n, (m, _, _) in d.later_state["adam"].items()}
    return {"grad_worst": _worst(grads, 3),
            "grad_ref": {n: ref["grads"][n] for n, _ in _worst(grads, 3)},
            # a gradient read back from Adam's first moment loses about
            # ulp(m) / (1 - b1) an entry: its share grows with |m| / |g|
            "moment_over_grad": {n: m0[n] / max(ref["grads"][n], 1e-30)
                                 for n, _ in _worst(grads, 3)},
            "change_worst": _worst(changes, 3),
            "pair_margins": seen[0] if seen else None}


def main(argv):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--window", type=float, default=0.0,
                   help="seconds of the cell's window before the check")
    p.add_argument("--device", default="cuda")
    p.add_argument("--look", action="store_true",
                   help="training cells: each step's loss gap and the "
                        "leaves with the widest gaps")
    args = p.parse_args(argv)
    cell = manifest.cell(ROOT, args.workload)
    stage = cell.stage_module()
    dev = torch.device(args.device)
    work = tempfile.mkdtemp(prefix="readings-")
    try:
        scene = (stage.scene(work, cell) if hasattr(stage, "scene")
                 else None)
        for s in args.seeds.split(","):
            t = time.time()
            d = stage.Driver(cell, int(s), dev, work, scene, args.fault)
            d.setup()
            if args.window > 0:
                d.window(args.window)
            d.free()
            out = {"seed": int(s), "program": stage.numbers(d)}
            if args.control:
                out["control"] = stage.numbers(d, control=True)
            if args.look and hasattr(stage, "reference"):
                ref = stage.reference(d, cell.config["precision"]["stated"])
                grads, changes = check.leaf_gaps(d.readings, ref)
                out["look"] = {
                    "loss_steps": [abs(a - b) / abs(b) for a, b in
                                   zip(d.readings["losses"], ref["losses"])],
                    "grad_worst": _worst(grads, 3),
                    "change_worst": _worst(changes, 4),
                    "change_median": sorted(changes.values())[
                        len(changes) // 2],
                    "ref_change": {n: ref["changes"][n] for n, _ in sorted(
                        changes.items(), key=lambda kv: -kv[1])[:4]}}
                if getattr(d, "later", None) is not None:
                    out["look"]["later"] = look_later(
                        stage, d, cell.config["precision"]["stated"])
            out["seconds"] = round(time.time() - t, 1)
            print(json.dumps(out), flush=True)
            del d
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
