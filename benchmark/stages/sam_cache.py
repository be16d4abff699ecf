"""Stage 2's feature cache, a view at a time: a closed loop of the port's
`train.stages.encode_view` (the function `store_sam_features` calls for
each view: the render through the field, SAM's `set_image` on the uint8
rendering, the features read back to numpy) over the scene's views in
order, cycled.  The field is built as the other cells build it, through
the CLI's parser with the configuration's and the mix's flags; SAM as the
CLI builds it without a checkpoint (`build_sam(--sam_model_type,
seed=--seed)`, random weights drawn on the device) and checked against the
configuration's widths.  The cache's `.npy` write is left out.

Besides the window's views, set-up encodes the configuration's
`photos` of the scene's own images through the same `set_image`, so that
the check sees images with structure where a field drawn from the seed
renders a near-flat one.

The numbers compared, over the sampled views and the photos, each
against the plain reference (benchmark/reference/sam.py) from the same
uint8 image and the same weights:
  input_levels  the widest gap between the program's encoder input and
                the reference's preprocessing of the same image, in
                levels of 255 (the two resizes differ in rounding);
  feat_rel      the widest RMS gap of the features [g, g, 256] over the
                reference's RMS, the reference encoding the program's
                input;
  interm_rel    the same of the first global block's output (block 7 of
                ViT-H, which HQ-SAM's decoder reads);
  image_rmse    the sampled views' renders against the reference's render
                of the same pose (stages/render.py)."""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness.drivers import span, sync
from benchmark.harness.scene import llff_poses
from benchmark.reference import sam as ref_sam
from benchmark.stages import nerf, render

scene = nerf.scene


class SamCounts:
    """Multiply-adds, model FLOPs and parameters of one encode, from
    the configuration's `sam` widths.  The windowed blocks run their qkv
    and proj products on the padded grid (window partition pads before
    attention) and their MLP on the unpadded one; softmax, norms and GELU
    are not counted."""

    def __init__(self, sam: dict):
        self.s = sam

    def encode_macs(self) -> Dict[str, int]:
        s = self.s
        C, nh, ws = s["embed_dim"], s["num_heads"], s["window_size"]
        g = s["img_size"] // s["patch_size"]
        d, hidden, out = C // nh, int(C * s["mlp_ratio"]), s["out_chans"]
        tokens = g * g
        gp = -(-g // ws) * ws
        n_glob = len(s["global_attn_indexes"])
        n_win = s["depth"] - n_glob
        wt = ws * ws
        mlp = tokens * 2 * C * hidden
        return {
            "patch": tokens * 3 * s["patch_size"] ** 2 * C,
            "window_linears": n_win * (gp * gp * 4 * C * C + mlp),
            # QK^T, AV and the two rel-pos einsums of every window and head
            "window_attention": n_win * (gp // ws) ** 2 * nh
            * (2 * wt * wt * d + 2 * wt * ws * d),
            "global_linears": n_glob * (tokens * 4 * C * C + mlp),
            "global_attention": n_glob * nh
            * (2 * tokens * tokens * d + 2 * tokens * g * d),
            "neck": tokens * C * out + tokens * out * out * 9}

    def encode_flops(self) -> float:
        return 2.0 * sum(self.encode_macs().values())

    def encode_params(self) -> int:
        s = self.s
        C, nh, ws = s["embed_dim"], s["num_heads"], s["window_size"]
        g = s["img_size"] // s["patch_size"]
        d, hidden, out = C // nh, int(C * s["mlp_ratio"]), s["out_chans"]
        n_glob = len(s["global_attn_indexes"])
        block = 4 * C + 4 * C * C + 4 * C + 2 * C * hidden + hidden + C
        rel = 2 * (2 * ws - 1) * d * (s["depth"] - n_glob) \
            + 2 * (2 * g - 1) * d * n_glob
        return (3 * s["patch_size"] ** 2 * C + C + g * g * C
                + s["depth"] * block + rel + C * out + 9 * out * out
                + 4 * out)


def counts(cell):
    return SamCounts(cell.config["sam"])


def _widths(encoder) -> dict:
    """The widths of a built image encoder, under the configuration's
    keys."""
    blk = encoder.blocks[0]
    C, _, p, _ = encoder.patch_embed.proj.weight.shape
    windows = [b.window_size for b in encoder.blocks]
    return {"img_size": encoder.pos_embed.shape[1] * p, "patch_size": p,
            "embed_dim": C, "depth": len(encoder.blocks),
            "num_heads": blk.attn.num_heads,
            "mlp_ratio": blk.mlp.lin1.weight.shape[0] / C,
            "out_chans": encoder.neck[0].weight.shape[0],
            "window_size": max(windows),
            "global_attn_indexes": [i for i, w in enumerate(windows)
                                    if w == 0]}


class Driver(nerf.NerfDriver):
    KEEP = nerf.NerfDriver.KEEP + ("answers", "photos", "keep", "poses",
                                   "intr", "H", "W", "sam_params")

    def setup(self):
        # a program without the per-view function fails here, at once
        from sanerf_hq_tpu_torch.train.stages import encode_view
        from sanerf_hq_tpu_torch.sam import SamPredictor, build_sam

        self.encode_view = encode_view
        self.build()
        s = self.cell.config["sam"]
        cfg = self.prog.cfg
        sam = build_sam(cfg.sam_model_type, hq=cfg.sam_type == "sam_hq",
                        img_size=s["img_size"], seed=cfg.seed,
                        device=self.device)
        built = _widths(sam.image_encoder)
        if any(built[k] != s[k] for k in built):
            raise ValueError(f"{cfg.sam_model_type} built at {built}, the "
                             f"configuration states {s}")
        self.predictor = SamPredictor(sam, img_size=s["img_size"])
        # the weights the reference reads (the program only reads them)
        self.sam_params = dict(sam.image_encoder.state_dict())
        self.mark("build sam")

        images = self.scene["images"]
        self.H, self.W = images.shape[1:3]
        self.poses = llff_poses(self.scene["poses"])
        self.intr = np.asarray(self.scene["intrinsics"], np.float32)
        rng = np.random.default_rng(self.seed)
        chk = self.tr["check"]
        self.keep = set(int(i) for i in rng.choice(chk["within"],
                                                   chk["views"],
                                                   replace=False))
        self._capture()
        self.answers: Dict[int, dict] = {}
        self.photos: Dict[int, dict] = {}
        for i in rng.choice(images.shape[0], self.tr["photos"],
                            replace=False):
            feats = self.predictor.set_image(images[int(i)])
            self.photos[int(i)] = self._answer(feats[0].cpu().numpy())
        self.k = 0
        for i in range(self.tr["warmup_views"]):
            self.encode_view(self.trainer, self.predictor,
                             self.poses[-1 - i], self.intr, self.H, self.W)
        sync(self.device)
        self.mark("warm-up")

    def _capture(self):
        """Keep the last rendering, and the uint8 image and the encoder
        input of the last set_image, for the answers the check samples:
        the input is the one the encoder ran on, not made again."""
        self._last = {}
        render_view, preprocess = (self.trainer.render_view,
                                   self.predictor.preprocess)

        def rendered(*a, **kw):
            self._last["render"] = out = render_view(*a, **kw)
            return out

        def prepared(image):
            x, size = preprocess(image)
            self._last["rgb"], self._last["input"] = image, x
            return x, size

        self.trainer.render_view = rendered
        self.predictor.preprocess = prepared

    def _answer(self, feats: np.ndarray) -> dict:
        return {"features": np.array(feats),
                "rgb": np.array(self._last["rgb"]),
                "input": self._last["input"].cpu(),
                "interm": self.predictor.interm_features[0][0].cpu(),
                "image": np.array(self._last["render"]["image"])
                if "render" in self._last else None}

    def _view(self, tracing: bool) -> np.ndarray:
        with span(tracing, "sam_cache_view"):
            feats = self.encode_view(
                self.trainer, self.predictor,
                self.poses[self.k % len(self.poses)], self.intr, self.H,
                self.W)
        if self.fault == "half":
            feats = feats.copy()
            feats[:feats.shape[0] // 2] = 0.0
        elif self.fault == "altered":
            feats = feats + 0.02 * float(np.sqrt(np.mean(feats ** 2)))
        return feats

    def window(self, seconds: float, tracing: bool = False,
               steps: Optional[int] = None) -> dict:
        lat, t0 = [], time.perf_counter()
        while (len(lat) < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            t = time.perf_counter()
            feats = self._view(tracing)
            lat.append(time.perf_counter() - t)
            self._sample(feats)
        dt = time.perf_counter() - t0
        # the client asks on, uncounted, for sampled views a short window
        # did not reach
        while self.k <= max(self.keep):
            self._sample(self._view(False))
        return {"views": len(lat), "seconds": dt, "latency_s": lat,
                "steps": len(lat)}

    def _sample(self, feats):
        if self.k in self.keep:
            self.answers[self.k] = self._answer(feats)
        self.k += 1


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt()
                 / b.pow(2).mean().sqrt().clamp_min(1e-30))


def numbers(driver, control: bool = False):
    cfg = driver.cell.config
    s, prec = cfg["sam"], cfg["precision"]
    dev = driver.device
    if any(k not in driver.answers for k in driver.keep):
        return {k: math.inf for k in ("input_levels", "feat_rel",
                                      "interm_rel", "image_rmse")}
    mean, std = (torch.tensor(v, device=dev, dtype=torch.float64)
                 for v in (ref_sam.PIXEL_MEAN, ref_sam.PIXEL_STD))

    def levels(x):  # the normalised input back to whole levels of 255
        return torch.round(x.double() * std + mean)

    out = {"input_levels": 0.0, "feat_rel": 0.0, "interm_rel": 0.0}
    for a in list(driver.answers.values()) + list(driver.photos.values()):
        x = a["input"].to(dev)
        x_ref, _ = ref_sam.preprocess(torch.as_tensor(a["rgb"], device=dev),
                                      s["img_size"])
        out["input_levels"] = max(out["input_levels"], float(
            (levels(x) - levels(x_ref)).abs().max()))
        feats, interm = ref_sam.encode(driver.sam_params, x, s,
                                       prec["stated"]["encoder"])
        if control:
            pf, pi = ref_sam.encode(driver.sam_params, x, s,
                                    prec["control"]["encoder"])
            pf, pi = pf[0], pi[0][0]
        else:
            pf = torch.as_tensor(a["features"], device=dev)
            pi = a["interm"].to(dev)
        out["feat_rel"] = max(out["feat_rel"], _rel(pf, feats[0]))
        out["interm_rel"] = max(out["interm_rel"], _rel(pi, interm[0][0]))
    keys = sorted(driver.keep)
    ref = render.render_reference(driver, prec["stated"], keys)
    prog = (render.render_reference(driver, prec["control"], keys)
            if control else driver.answers)
    out["image_rmse"] = max(float(np.sqrt(np.mean(
        (prog[k]["image"] - ref[k]["image"]) ** 2))) for k in keys)
    return out
