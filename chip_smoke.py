#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`sanerf_hq_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc of every CUDA source (sm_90a), all started together;
  3. kernels against their plain twins on the card (CUDA events, warm-up,
     median of 10), with bounds:
     - inference, one 16384-ray chunk: K5 (proposal level + resampling) at
       (T, Q) = (128, 65) and (64, 33), max abs error <= 1e-3 on the next
       s-bins; K3 (final level, CP-64) rel-max < 2e-2 on f_image, depth,
       weights_sum and weights; K6 (K3 with the per-sample trunk features)
       rel-max < 2e-2 on those four and geo, the four bitwise equal to
       K3's; K5 and K6 also timed at a 6256-ray stage-3 batch;
     - training, one 8192-ray batch with random cotangents: K1 at both
       proposal levels (bins max abs <= 1e-3 and equal to K5's, weights
       rel-max < 2e-2), K2 at T = 128 and 64 and K4 at T = 32 (rel-max
       < 2e-2 on every weight and CP grad; the weight grads bitwise equal
       over two launches; K4's CP grads, summed with atomics, print their
       run-to-run difference);
  4. inference path: a synthetic llff scene written under build/, the
     port's CLI `--test` on it at flagship width with a seeded field (2
     views of 512x512, 16 chunks each), with the launch counts set to 0
     just before and read just after: K5 must launch twice a chunk and K3
     once; then the render rate, and the level-kernel route against the
     composable route on a 128x128 view (max abs < 2e-2);
  5. training path: the port's CLI without --test on the same scene at
     flagship width, 20 steps of 8192 rays, counts set to 0 just before and
     read just after: per step K1 twice, K2 twice (every step <= 3000
     updates the proposal MLPs), K3 once and K4 once (K3 and K5 also run in
     the eval renders); a finite loss, checkpoints on disk, a later --test
     resuming from them, and the train step rate (host clock around
     synchronised steps);
  6. grad parity: on one 8192-ray batch at step 2000 (distortion ramp fully
     on, so K4's weights grad carries gradient), the level-kernel route's
     grads against the composable route's (autograd through the plain
     field), per-leaf rel-L2 <= 5%;
  7. stage 3: analytic sphere masks in the decode output format, then the
     CLI with --with_mask --init_ckpt <phase-5 workspace> and the flags of
     scripts/train_obj_nerf.sh (6000 rays and four 8x8 patches a step, 200
     steps, the ray-pair loss from step 150, the error map at 128), counts
     set to 0 just before and read just after: K5 twice and K6 once a step,
     a chunk and an error-map view, K1-K4 never; the backbone bitwise equal
     to the init checkpoint, the error map rebuilt at step 150, the CE at
     the first and last step, [EVAL] MeanIoU; then the step rate (host
     clock around synchronised steps) and its breakdown (CUDA events: the
     sampler, K5, K6, the mask branch forward and backward, the losses),
     the CP feature lookup as a one-hot matmul and as a gather, the frozen
     route against the composable route on one batch (CE within 2e-2,
     logits within 3e-2, trainable grads rel-max < 6e-2), and a
     --test --with_mask resuming the field;
  8. the hash-grid field (the CLI default, at the published widths): K10
     (inverse-CDF lookup) against its plain version at N = 16384 and 8192
     with (K, Q) = (129, 65) and (65, 33) on rows with ties, max abs <=
     1e-6, timed beside a searchsorted composite (this check runs with
     phase 3); the CLI without --field_type, 20 steps of 8192 rays on the
     phase-4 scene, counts set to 0 just before and read just after: K10
     twice a step and twice an eval chunk, K1-K6 never; a finite loss,
     checkpoints, the step rate with its breakdown (CUDA events: the
     sampler, the three hash encodes forward and backward, K10, the MLPs,
     compositing and losses, Adam; one device-only torch.profiler trace);
     a --test resuming it (K10 twice a chunk) and the render rate; the
     card against the CPU on one 1024-ray batch with the same weights
     (the CPU handed the card's resampled bins: image, depth, losses max
     abs <= 1e-3, table grads rel-max <= 1e-3; on its own bins the output
     bar, grads printed);
     then --field_type hashgrid_packed, 5 steps of 8192 rays;
  9. one JSON line with every kernel's numbers, the device line again, and
     the last line {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data.png import read_png
from sanerf_hq_tpu_torch.data.provider import load_scene, split_indices
from sanerf_hq_tpu_torch.data.rays import full_frame_rays
from sanerf_hq_tpu_torch.data.sampler import (fixed_fovy_intrinsics,
                                              sample_mask_batch,
                                              sample_rgb_batch)
from sanerf_hq_tpu_torch.data.synthetic import (look_at_pose, write_llff_scene,
                                                write_sphere_masks)
from sanerf_hq_tpu_torch.models import SANeRFField, make_field
from sanerf_hq_tpu_torch.ops import cuda_lib
from sanerf_hq_tpu_torch.ops import ray as ray_ops
from sanerf_hq_tpu_torch.ops import render_level as rl
from sanerf_hq_tpu_torch.ops.composite import (compute_weights, distort_loss,
                                               proposal_loss)
from sanerf_hq_tpu_torch.ops.hashgrid import hash_encode
from sanerf_hq_tpu_torch.ops.ray import (near_far_from_aabb, spacing_fn,
                                         spacing_fn_inv, stratified_queries)
from sanerf_hq_tpu_torch.ops.sample_pdf import (sample_pdf_lookup,
                                                sample_pdf_lookup_ref)
from sanerf_hq_tpu_torch.ops.sh import sh_encode
from sanerf_hq_tpu_torch.render.renderer import RenderSettings, render_rays
from sanerf_hq_tpu_torch.train.checkpoints import CheckpointManager
from sanerf_hq_tpu_torch.train.steps import (make_mask_train_step,
                                             make_rgb_train_step, mask_losses)

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "sanerf_hq_tpu_torch/csrc/render_level.cu"
SOURCE_BWD = "sanerf_hq_tpu_torch/csrc/render_level_bwd.cu"
SOURCE_PDF = "sanerf_hq_tpu_torch/csrc/sample_pdf.cu"
TPU_FILE = "sanerf_hq_tpu/ops/render_level_pallas.py"
TPU_FILE_PDF = "sanerf_hq_tpu/ops/sample_pdf_pallas.py"
# H100 SXM published peaks: bf16 dense tensor cores, fp32 outside them, HBM3
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
CHUNK = 16384  # rays in one render chunk (max_ray_batch)
BATCH = 8192  # rays of a training step: num_points 2**18 / 32 samples
VIEW = 512  # main-path views are VIEW x VIEW
TRAIN_STEPS = 20
MASK_BATCH = 6000 + 4 * 8 * 8  # stage-3 rays a step: global + patches
MASK_STEPS = 200
HG_STEPS = 20  # hash-grid CLI training steps (depth cut from 20000)
PACKED_STEPS = 5
CPU_RAYS = 1024  # the card-vs-CPU batch
COUNTERS = {"K5": rl.fused_prop_level_sample, "K3": rl.fused_final_level,
            "K6": rl.fused_final_level_frozen,
            "K1": rl.fused_prop_level_sample_train,
            "K2": rl.fused_prop_level_bwd, "K4": rl.fused_final_level_bwd,
            "K10": sample_pdf_lookup}
LEVEL_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, reps=20):
    """Device time of one fn() without the host's launch overhead: reps
    calls captured into one CUDA graph, replayed between CUDA events
    (median of 10 replays) and divided by reps.  For kernels that take
    less time on the card than their wrapper takes on the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def bound(n_bytes, bf16_flops, fp32_ops):
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(bf16_flops / PEAK_BF16, fp32_ops / PEAK_FP32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def mlp_macs(ws):
    return sum(w.shape[0] * w.shape[1] for w in ws)


def rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in COUNTERS.items()}


def view_rays(dev, H, W):
    pose = torch.as_tensor(look_at_pose([2.0, 0.4, 0.5]), device=dev)
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(50.0))
    intr = torch.tensor([focal, focal, W / 2, H / 2], device=dev)
    return full_frame_rays(pose, intr, H, W)


def s_space(ro, rd):
    b = 128.0
    aabb = torch.tensor([-b, -b, -b, b, b, b], device=ro.device)
    nears, fars = near_far_from_aabb(ro, rd, aabb, 0.2)
    return spacing_fn(nears), spacing_fn(fars)


def check_kernels(field):
    """Phase 3: each kernel against its plain twin on one flagship chunk."""
    dev = field.cp_x.device
    ro, rd = view_rays(dev, 128, 128)
    N = ro.shape[0]
    assert N == CHUNK
    sn, sf = s_space(ro, rd)
    args = dict(freq_degree=field.prop_freq_degree,
                grid_bound=field.grid_bound, opaque_last=True,
                density_bias=field.density_bias)
    results = {}

    # K5 at both proposal levels; the second takes the first's output
    s_bins = torch.linspace(0.0, 1.0, 129, device=dev).expand(N, 129)
    s_bins = s_bins.contiguous()
    k5 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
          "per_shape": {}}
    for level, (T, Q) in enumerate(((128, 65), (64, 33))):
        real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
        u = stratified_queries(N, Q, dev).contiguous()
        ws = (field.prop_mlp_0 if level == 0 else field.prop_mlp_1).weights
        call = (ro, rd, real, s_bins, u, ws)
        got = rl.fused_prop_level_sample(*call, **args)
        want = rl.prop_level_sample_ref(*call, **args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert torch.isfinite(got).all(), "K5 output not finite"
        assert err <= 1e-3, f"K5 (T={T}, Q={Q}) max abs error {err}"
        ms = cuda_ms(lambda: rl.fused_prop_level_sample(*call, **args))
        plain = cuda_ms(lambda: rl.prop_level_sample_ref(*call, **args))
        pts = N * T
        bms, by = bound(nbytes(ro, rd, real, s_bins, u, *ws) + got.numel() * 4,
                        2 * pts * mlp_macs(ws),
                        2 * pts * 3 * field.prop_freq_degree)
        print(f"[kernel] K5 fused_prop_level_sample T={T} Q={Q}: max abs err "
              f"{err:.3e} (<= 1e-3), {ms:.4f} ms, plain twin {plain:.4f} ms, "
              f"bound {bms:.4f} ms ({by})", flush=True)
        small = [x[:MASK_BATCH] for x in call[:5]]
        ms_b = cuda_ms(lambda: rl.fused_prop_level_sample(*small, ws, **args))
        print(f"[kernel] K5 T={T} Q={Q} at the {MASK_BATCH}-ray stage-3 "
              f"batch: {ms_b:.4f} ms", flush=True)
        k5["per_shape"][f"T{T}_Q{Q}"] = {"ms": ms, "plain_ms": plain,
                                        "bound_ms": bms, "max_abs_err": err,
                                        f"ms_{MASK_BATCH}_rays": ms_b}
        k5["ms"] += ms
        k5["plain_ms"] += plain
        k5["bound_ms"] += bms
        k5["bound_by"] = by
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        s_bins = got
    results["K5"] = k5

    # K3 on the final level's bins
    real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
    sh = sh_encode(rd / torch.linalg.norm(rd, dim=-1, keepdim=True))
    ws, cps = field.trunk.weights, field.cp_basis
    call = (ro, rd, real, sh, ws)
    args3 = dict(freq_degree=field.freq_degree, skip_layer=2,
                 grid_bound=field.grid_bound, opaque_last=True,
                 density_bias=field.density_bias, cps=cps,
                 cp_res=field.cp_res)
    got = rl.fused_final_level(*call, **args3)
    want = rl.final_level_ref(*call, **args3)
    torch.cuda.synchronize()
    rel = 0.0
    for name, a, b_ in zip(("f_image", "depth", "weights_sum", "weights"),
                           got, want):
        assert torch.isfinite(a).all(), f"K3 {name} not finite"
        r = ((a - b_).abs().max() / b_.abs().max().clamp_min(1e-12)).item()
        assert r < 2e-2, f"K3 {name} rel-max error {r}"
        rel = max(rel, r)
        print(f"[kernel] K3 fused_final_level {name}: rel-max err {r:.3e} "
              "(< 2e-2)", flush=True)
    ms = cuda_ms(lambda: rl.fused_final_level(*call, **args3))
    plain = cuda_ms(lambda: rl.final_level_ref(*call, **args3))
    T = real.shape[1] - 1
    abs_err = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
    bms, by = bound(nbytes(ro, rd, real, sh, *ws, *cps, *got),
                    2 * N * T * mlp_macs(ws),
                    2 * N * T * 3 * field.freq_degree)
    print(f"[kernel] K3 fused_final_level T={T} CP-{field.cp_rank}: "
          f"{ms:.4f} ms, plain twin {plain:.4f} ms, bound {bms:.4f} ms ({by})",
          flush=True)
    results["K3"] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "max_abs_err": abs_err,
                     "rel_max_err": rel}
    results["K6"] = check_frozen_kernel(field, call, args3, got)
    return results


def check_frozen_kernel(field, call, args3, k3_out):
    """K6 on the K3 chunk: against its twin, against K3 bit for bit, and
    timed at the chunk and at the stage-3 batch."""
    got = rl.fused_final_level_frozen(*call, **args3, need_geo=True)
    want = rl.final_level_frozen_ref(*call, **args3, need_geo=True)
    torch.cuda.synchronize()
    rels = {}
    for name, a, b_ in zip(("f_image", "depth", "weights_sum", "weights",
                            "geo"), got, want):
        assert torch.isfinite(a).all(), f"K6 {name} not finite"
        rels[name] = rel_max(a, b_)
        assert rels[name] < 2e-2, f"K6 {name} rel-max error {rels[name]}"
    for name, a, b_ in zip(("f_image", "depth", "weights_sum", "weights"),
                           got, k3_out):
        assert torch.equal(a, b_), f"K6 {name} differs from K3's"
    abs_err = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
    ws, cps = call[4], args3["cps"]
    ms = cuda_ms(lambda: rl.fused_final_level_frozen(*call, **args3,
                                                     need_geo=True))
    plain = cuda_ms(lambda: rl.final_level_frozen_ref(*call, **args3,
                                                      need_geo=True))
    N, T = call[0].shape[0], call[2].shape[1] - 1

    def bound_at(n, outs):
        return bound(nbytes(*(x[:n] for x in call[:4]), *ws, *cps, *outs),
                     2 * n * T * mlp_macs(ws),
                     2 * n * T * 3 * field.freq_degree)

    bms, by = bound_at(N, got)
    small = [x[:MASK_BATCH] for x in call[:4]]
    got_b = rl.fused_final_level_frozen(*small, ws, **args3, need_geo=True)
    ms_b = cuda_ms(lambda: rl.fused_final_level_frozen(*small, ws, **args3,
                                                       need_geo=True))
    bms_b, by_b = bound_at(MASK_BATCH, got_b)
    print("[kernel] K6 fused_final_level_frozen need_geo: rel-max err "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + " (< 2e-2); f_image, depth, weights_sum, weights bitwise equal "
          f"to K3's; {ms:.4f} ms at {N} rays (K3 above), plain twin "
          f"{plain:.4f} ms, bound {bms:.4f} ms ({by}); {ms_b:.4f} ms at "
          f"{MASK_BATCH} rays, bound {bms_b:.4f} ms ({by_b})", flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "max_abs_err": abs_err, "rel_max_err": max(rels.values()),
            "equal_to_K3": True,
            "per_shape": {f"N{MASK_BATCH}": {"ms": ms_b, "bound_ms": bms_b,
                                             "bound_by": by_b}}}


def check_train_kernels(field):
    """Phase 3, training: K1, K2 and K4 against their twins on one
    8192-ray batch, with seeded random cotangents."""
    dev = field.cp_x.device
    ro, rd = view_rays(dev, 64, 128)
    N = ro.shape[0]
    assert N == BATCH
    sn, sf = s_space(ro, rd)
    g = torch.Generator(dev).manual_seed(0)
    pargs = dict(freq_degree=field.prop_freq_degree,
                 grid_bound=field.grid_bound, opaque_last=True,
                 density_bias=field.density_bias)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
          "per_shape": {}}
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
          "per_shape": {}}
    s_bins = torch.linspace(0.0, 1.0, 129, device=dev).expand(N, 129)
    s_bins = s_bins.contiguous()
    for level, (T, Q) in enumerate(((128, 65), (64, 33))):
        real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
        u = stratified_queries(N, Q, dev).contiguous()
        ws = (field.prop_mlp_0 if level == 0 else field.prop_mlp_1).weights
        call = (ro, rd, real, s_bins, u, ws)
        w, nb = rl.fused_prop_level_sample_train(*call, **pargs)
        w_ref, nb_ref = rl.prop_level_train_sample_ref(*call, **pargs)
        nb5 = rl.fused_prop_level_sample(*call, **pargs)
        torch.cuda.synchronize()
        assert torch.isfinite(w).all() and torch.isfinite(nb).all()
        err = (nb - nb_ref).abs().max().item()
        rel = rel_max(w, w_ref)
        assert err <= 1e-3, f"K1 (T={T}) bins max abs error {err}"
        assert rel < 2e-2, f"K1 (T={T}) weights rel-max error {rel}"
        assert torch.equal(nb, nb5), "K1's bins differ from K5's"
        ms = cuda_ms(lambda: rl.fused_prop_level_sample_train(*call, **pargs))
        plain = cuda_ms(
            lambda: rl.prop_level_train_sample_ref(*call, **pargs))
        pts = N * T
        bms, by = bound(nbytes(ro, rd, real, s_bins, u, *ws, nb, w),
                        2 * pts * mlp_macs(ws),
                        2 * pts * 3 * field.prop_freq_degree)
        print(f"[kernel] K1 fused_prop_level_sample_train T={T} Q={Q}: bins "
              f"max abs err {err:.3e} (<= 1e-3, equal to K5's), weights "
              f"rel-max {rel:.3e} (< 2e-2), {ms:.4f} ms, plain twin "
              f"{plain:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        k1["per_shape"][f"T{T}_Q{Q}"] = {"ms": ms, "plain_ms": plain,
                                        "bound_ms": bms, "max_abs_err": err,
                                        "weights_rel_max": rel}

        # K2 on this level's weights grad
        g_w = torch.randn(N, T, generator=g, device=dev)
        bcall = (ro, rd, real, ws, g_w)
        got = rl.fused_prop_level_bwd(*bcall, **pargs)
        again = rl.fused_prop_level_bwd(*bcall, **pargs)
        want = rl.prop_level_bwd_ref(*bcall, **pargs)
        torch.cuda.synchronize()
        rels = []
        for i, (a, b_, c) in enumerate(zip(got, want, again)):
            assert torch.isfinite(a).all(), f"K2 dW{i} not finite"
            rels.append(rel_max(a, b_))
            assert rels[-1] < 2e-2, f"K2 (T={T}) dW{i} rel-max {rels[-1]}"
            assert torch.equal(a, c), f"K2 (T={T}) dW{i} not deterministic"
        abs_err = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
        ms2 = cuda_ms(lambda: rl.fused_prop_level_bwd(*bcall, **pargs))
        plain2 = cuda_ms(lambda: rl.prop_level_bwd_ref(*bcall, **pargs))
        # forward recompute + dW (each the MLP's MACs) + dA of layers 2, 1
        macs = 2 * mlp_macs(ws) + mlp_macs(ws[1:])
        bms2, by2 = bound(nbytes(ro, rd, real, *ws, g_w, *got),
                          2 * pts * macs,
                          2 * pts * 3 * field.prop_freq_degree)
        print(f"[kernel] K2 fused_prop_level_bwd T={T}: rel-max err "
              + ", ".join(f"dW{i} {r:.3e}" for i, r in enumerate(rels))
              + f" (< 2e-2), bitwise equal over two launches, {ms2:.4f} ms, "
              f"plain twin {plain2:.4f} ms, bound {bms2:.4f} ms ({by2}, "
              f"{macs} MAC a sample)", flush=True)
        k2["per_shape"][f"T{T}"] = {"ms": ms2, "plain_ms": plain2,
                                   "bound_ms": bms2, "max_abs_err": abs_err,
                                   "rel_max_err": max(rels)}
        for k, part in ((k1, k1["per_shape"][f"T{T}_Q{Q}"]),
                        (k2, k2["per_shape"][f"T{T}"])):
            k["ms"] += part["ms"]
            k["plain_ms"] += part["plain_ms"]
            k["bound_ms"] += part["bound_ms"]
            k["max_abs_err"] = max(k["max_abs_err"], part["max_abs_err"])
        k1["bound_by"], k2["bound_by"] = by, by2
        s_bins = nb

    # K4 on the final level's bins, cotangents on all four K3 outputs
    real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
    T = real.shape[1] - 1
    sh = sh_encode(rd / torch.linalg.norm(rd, dim=-1, keepdim=True))
    ws, cps = field.trunk.weights, field.cp_basis
    cots = [torch.randn(*shape, generator=g, device=dev)
            for shape in ((N, 31), (N,), (N,), (N, T))]
    fargs = dict(freq_degree=field.freq_degree, skip_layer=2,
                 grid_bound=field.grid_bound, opaque_last=True,
                 density_bias=field.density_bias, cps=cps,
                 cp_res=field.cp_res)
    call = (ro, rd, real, sh, ws, *cots)
    dws, dcps = rl.fused_final_level_bwd(*call, **fargs)
    dws2, dcps2 = rl.fused_final_level_bwd(*call, **fargs)
    want_w, want_c = rl.final_level_bwd_ref(*call, **fargs)
    torch.cuda.synchronize()
    rels = {}
    for i, (a, b_, c) in enumerate(zip(dws, want_w, dws2)):
        assert torch.isfinite(a).all(), f"K4 dW{i} not finite"
        rels[f"dW{i}"] = rel_max(a, b_)
        assert rels[f"dW{i}"] < 2e-2, f"K4 dW{i} rel-max {rels[f'dW{i}']}"
        assert torch.equal(a, c), f"K4 dW{i} not deterministic"
    cp_run_diff = 0.0
    for a, (x, y, z) in enumerate(zip(dcps, want_c, dcps2)):
        assert torch.isfinite(x).all(), f"K4 dcp{a} not finite"
        rels[f"dcp{a}"] = rel_max(x, y)
        assert rels[f"dcp{a}"] < 2e-2, f"K4 dcp{a} rel-max {rels[f'dcp{a}']}"
        cp_run_diff = max(cp_run_diff, (x - z).abs().max().item())
    abs_err = max((a - b_).abs().max().item()
                  for a, b_ in zip(dws + dcps, want_w + want_c))
    ms = cuda_ms(lambda: rl.fused_final_level_bwd(*call, **fargs))
    plain = cuda_ms(lambda: rl.final_level_bwd_ref(*call, **fargs))
    H, rank = ws[1].shape[0], field.cp_rank
    # forward recompute + dW (each the trunk's MACs) + dA: layer 3, the
    # [act | CP] columns of layer 2, layer 1, the CP columns of layer 0
    macs = (2 * mlp_macs(ws) + ws[3].numel() + (H + rank) * H + H * H
            + rank * H)
    pts = N * T
    bms, by = bound(nbytes(ro, rd, real, sh, *ws, *cps, *cots, *dws, *dcps),
                    2 * pts * macs, 2 * pts * 3 * field.freq_degree)
    print("[kernel] K4 fused_final_level_bwd T=32 CP-64: rel-max err "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (< 2e-2); dW bitwise equal over two launches; dCP run-to-run "
          f"max abs difference {cp_run_diff:.3e} (fp32 atomics); {ms:.4f} ms, "
          f"plain twin {plain:.4f} ms, bound {bms:.4f} ms ({by}, {macs} MAC "
          "a sample)", flush=True)
    k4 = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
          "max_abs_err": abs_err, "rel_max_err": max(rels.values()),
          "dcp_run_to_run_max_abs": cp_run_diff}
    # K3, the training forward, at the same 8192-ray shape
    k3 = cuda_ms(lambda: rl.fused_final_level(ro, rd, real, sh, ws, **fargs))
    print(f"[kernel] K3 fused_final_level at the training shape (8192 rays, "
          f"T=32): {k3:.4f} ms", flush=True)
    return {"K1": k1, "K2": k2, "K4": k4, "K3_train_ms": k3}


def main_path(work):
    """Phase 4: the CLI --test path at flagship width, seeded init."""
    scene = os.path.join(work, "scene")
    ws_dir = os.path.join(work, "workspace")
    n_views, H, W = 17, VIEW, VIEW  # the default val split holds views 0, 16
    write_llff_scene(scene, n_views=n_views, H=H, W=W)
    argv = [scene, "--test", "--field_type", "mlp", "--data_type", "llff",
            "--workspace", ws_dir, "--seed", "0"]

    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()

    chunks = 2 * -(-H * W // trainer.cfg.max_ray_batch)
    print(f"[main] CLI --test: 2 views of {H}x{W}, {chunks} chunks in "
          f"{dt:.2f} s; launches K5 {launches['K5']}, K3 {launches['K3']}",
          flush=True)
    assert launches["K5"] == 2 * chunks, launches
    assert launches["K3"] == chunks, launches
    assert launches["K1"] == launches["K2"] == launches["K4"] == 0, launches
    assert launches["K10"] == 0, launches  # no composable level
    for stem in ("v00", "v16"):
        img = read_png(os.path.join(ws_dir, "results", f"{stem}_rgb.png"))
        depth = np.load(os.path.join(ws_dir, "results", f"{stem}_depth.npy"))
        assert img.shape == (H, W, 3), img.shape
        assert depth.shape == (H, W) and np.isfinite(depth).all()

    # render rate on one warm 512x512 view
    dset_pose = look_at_pose([2.0, 0.4, 0.0])  # not a view of the scene
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(50.0))
    intr = np.array([focal, focal, W / 2, H / 2], np.float32)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.render_view(dset_pose, intr, H, W)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mrays = H * W / float(np.median(times)) / 1e6
    print(f"[main] render {mrays:.4f} Mrays/s ({H}x{W} view, median of 3, "
          f"{np.median(times) * 1e3:.2f} ms a view)", flush=True)

    # level-kernel route vs the composable route on a 128x128 view
    dev = trainer.device
    h = w = 128
    f = 0.5 * h / np.tan(0.5 * np.deg2rad(50.0))
    ro, rd = full_frame_rays(
        torch.as_tensor(dset_pose, device=dev),
        torch.tensor([f, f, w / 2, h / 2], dtype=torch.float32, device=dev),
        h, w)
    s = RenderSettings()
    with torch.inference_mode():
        a = render_rays(trainer.model, ro, rd, s)
        b = render_rays(trainer.model, ro, rd,
                        RenderSettings(level_kernels=False))
    for k in ("image", "depth", "weights_sum"):
        assert torch.isfinite(a[k]).all(), k
        err = (a[k] - b[k]).abs().max().item()
        print(f"[main] level-kernel vs composable route {k}: max abs "
              f"{err:.3e} (< 2e-2)", flush=True)
        assert err < 2e-2, (k, err)
    return launches, mrays


def train_path(work):
    """Phase 5: the CLI training run at flagship width, 8192 rays a step;
    then the train step rate and a --test resuming the checkpoint."""
    scene = os.path.join(work, "scene")
    ws_dir = os.path.join(work, "train_ws")
    argv = [scene, "--field_type", "mlp", "--data_type", "llff",
            "--workspace", ws_dir, "--seed", "0", "--iters",
            str(TRAIN_STEPS), "--eval_cnt", "1", "--save_cnt", "1"]
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    n = trainer.state.step
    assert trainer.cfg.num_rays == BATCH, trainer.cfg.num_rays
    print(f"[train] CLI: {n} steps of {trainer.cfg.num_rays} rays, eval and "
          f"checkpoints in {dt:.2f} s; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items()), flush=True)
    assert n == TRAIN_STEPS, n
    assert launches["K1"] == 2 * n and launches["K2"] == 2 * n, launches
    assert launches["K4"] == n, launches
    assert launches["K5"] > 0 and launches["K5"] % 2 == 0, launches
    assert launches["K3"] == n + launches["K5"] // 2, launches
    assert launches["K10"] == 0, launches
    losses = trainer.stats["loss"]
    assert losses and all(np.isfinite(losses)), losses
    ckpts = sorted(os.listdir(os.path.join(ws_dir, "checkpoints")))
    assert f"step_{n:08d}.pt" in ckpts and "best.pt" in ckpts, ckpts
    assert os.path.exists(os.path.join(ws_dir, "validation", "v00_rgb.png"))
    print(f"[train] losses by epoch {losses}; checkpoints {ckpts}",
          flush=True)

    # step rate: host clock around synchronised steps, batches sampled as
    # the trainer samples them (steps past iters only lower the lr)
    state, cfg = trainer.state, trainer.cfg
    scene_t = train_tensors(scene, trainer.device)
    gen = torch.Generator(trainer.device).manual_seed(1)

    def step():
        batch = sample_rgb_batch(gen, *scene_t, cfg.num_rays,
                                 random_image_batch=cfg.random_image_batch)
        return trainer.train_step(state, batch, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        m = step()
    torch.cuda.synchronize()
    sps = reps / (time.perf_counter() - t0)
    assert np.isfinite(float(m["loss"]))
    print(f"[train] {sps:.3f} steps/s at {cfg.num_rays} rays a step "
          f"({1e3 / sps:.2f} ms a step, mean of {reps} after 3 warm-up)",
          flush=True)

    resumed = cli.main([scene, "--test", "--field_type", "mlp", "--data_type",
                        "llff", "--workspace", ws_dir])
    assert resumed.resumed and resumed.state.step == n, resumed.state.step
    print(f"[train] --test resumed at step {resumed.state.step}", flush=True)
    return trainer, launches, sps


def train_tensors(scene, dev):
    """(images, poses, intrinsics) of the scene's training views on dev."""
    s = load_scene(scene, "llff")
    idx = split_indices(s.poses.shape[0], "train")
    return tuple(torch.as_tensor(np.asarray(x[idx], np.float32), device=dev)
                 for x in (s.images, s.poses, s.intrinsics))


def grad_parity(trainer, scene):
    """Phase 6: level-kernel route against the composable route, grads of
    the training loss on one 8192-ray batch at step 2000."""
    cfg, model = trainer.cfg, trainer.model
    gen = torch.Generator(trainer.device).manual_seed(2)
    batch = sample_rgb_batch(gen, *train_tensors(scene, trainer.device),
                             BATCH, random_image_batch=True)
    params = [p for _, p in model.named_parameters()]
    grads = {}
    for route in (True, False):
        loss_fn = make_rgb_train_step(model, cfg, perturb=False,
                                      level_kernels=route).loss_fn
        loss, _ = loss_fn(batch, 2000, True)
        grads[route] = torch.autograd.grad(loss, params)
    per_leaf = {}
    for (name, _), a, b_ in zip(model.named_parameters(), grads[True],
                                grads[False]):
        nb = b_.norm().item()
        if nb <= 1e-9:
            continue
        per_leaf[name] = ((a - b_).norm() / nb).item()
    worst = max(per_leaf, key=per_leaf.get)
    ranked = sorted(per_leaf.items(), key=lambda kv: -kv[1])
    print("[parity] per-leaf rel-L2, kernel vs composable route: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ranked), flush=True)
    print(f"[parity] worst {worst} {per_leaf[worst]:.4f} (<= 0.05)",
          flush=True)
    assert per_leaf[worst] <= 0.05, (worst, per_leaf[worst])
    assert len(per_leaf) == len(params), sorted(per_leaf)
    return per_leaf


def gather_mask_features(model, x):
    """The mask field's CP lookup as a two-tap gather (the form of the
    trunk's CP features), timed against the port's one-hot matmul form;
    the port does not call it."""
    g = rl.cp_features(x / model.grid_bound,
                       [model.cp_m_x, model.cp_m_y, model.cp_m_z],
                       model.feat_res)
    return g @ model.cp_m_proj


def capture_render(model, settings, batch, names=(
        "fused_prop_next_bins", "fused_final_render_frozen", "mask_features"),
        generator=None):
    """One render of a batch with the arguments and outputs of the field's
    methods `names` recorded (by default the frozen route's K5, K6 and
    mask-feature calls)."""
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            calls.setdefault(name, []).append((a, k, out))
            return out
        return wrapped

    for name in names:
        setattr(model, name, spy(name, getattr(model, name)))
    try:
        out = render_rays(model, batch["rays_o"], batch["rays_d"], settings,
                          generator=generator)
    finally:
        for name in names:
            delattr(model, name)
    return out, calls


STAGE3_GROUPS = (("K5", ("prop_level_sample_kernel",)),
                 ("K6", ("final_level_kernel",)),
                 ("matrix products", ("gemm", "cutlass")))


def profile_steps(step, kinds=STAGE3_GROUPS, n=5):
    """Device time of n steps by kernel from one torch.profiler trace
    (CUPTI) that records the device's activity alone, so that the host
    pays little for it: each group of `kinds` (name, substrings of the
    lower-case kernel names it takes; the first match wins), everything
    else, and the device's idle share of the trace's own span (first
    device activity to the last; idle is the span less the union of the
    activities).  A trace of the host too is taken only if the device-only
    one holds no device events.  Returns ms a step by group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
        print("[profile] the device-only trace holds no device events; "
              "tracing the host too", flush=True)
    assert events, "the profiler recorded no device activity"
    groups = {g: 0.0 for g, _ in kinds}
    groups["other"] = 0.0
    by_name = {}
    for e in events:  # the device's own events: kernels, copies, memsets
        ms = e.time_range.elapsed_us() / 1e3 / n
        name = e.name.lower()
        g = next((g for g, subs in kinds if any(x in name for x in subs)),
                 "other")
        groups[g] += ms
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    union, (lo, hi) = 0.0, spans[0]
    for s, t in spans[1:]:
        if s > hi:
            union, lo, hi = union + hi - lo, s, t
        else:
            hi = max(hi, t)
    union += hi - lo
    span = (max(t for _, t in spans) - spans[0][0]) / 1e3 / n
    busy = union / 1e3 / n
    groups["device busy"] = busy
    groups["device idle"] = span - busy
    groups["span"] = span
    groups["idle share"] = (span - busy) / span
    groups["wall"] = wall
    print(f"[profile] {n} steps, one trace of {len(acts)} activity kind(s), "
          "ms a step: " + ", ".join(f"{k} {v:.4f}" for k, v in groups.items())
          + " (idle share of the trace's device span; wall is the host "
          "clock with the profiler on)", flush=True)
    print("[profile] top kernels, ms a step: " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]), flush=True)
    return groups


def stage3_path(work, init_ws):
    """Phase 7: the stage-3 CLI run over the phase-5 field, its step rate
    and breakdown, the route check, and a --test --with_mask resume."""
    scene = os.path.join(work, "scene")
    masks_dir = os.path.join(work, "masks")
    ws_dir = os.path.join(work, "obj_ws")
    n_views = 17
    write_sphere_masks(masks_dir, n_views=n_views, H=VIEW, W=VIEW)
    init = torch.load(CheckpointManager(init_ws).latest_path(),
                      map_location="cpu", weights_only=True)["model"]
    # scripts/train_obj_nerf.sh, on the synthetic llff scene (its default
    # held-out views instead of a test-view list)
    argv = [scene, "--field_type", "mlp", "--data_type", "llff",
            "--workspace", ws_dir, "--seed", "0", "--init_ckpt", init_ws,
            "--with_mask", "--mask_root", masks_dir, "--num_rays", "6000",
            "--iters", str(MASK_STEPS), "--ray_pair_rgb_loss_weight", "1",
            "--ray_pair_rgb_threshold", "0.1", "--ray_pair_rgb_iter", "150",
            "--ray_pair_rgb_num_sample", "8", "--local_sample_patch_size",
            "8", "--num_local_sample", "4", "--mixed_sampling",
            "--random_image_batch", "--error_map"]
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    cfg, model = trainer.cfg, trainer.model
    n_train = n_views - 2
    n_rays = (cfg.num_rays
              + cfg.num_local_sample * cfg.local_sample_patch_size ** 2)
    rebuilds = [s_ for s_ in range(1, MASK_STEPS + 1)
                if s_ % cfg.ray_pair_rgb_iter == 0]
    val_chunks = 2 * -(-VIEW * VIEW // cfg.max_ray_batch)
    em_chunks = len(rebuilds) * n_train * -(-cfg.error_map_size ** 2
                                             // cfg.max_ray_batch)
    print(f"[stage3] CLI: {trainer.state.step} steps of {n_rays} rays, "
          f"error-map rebuilds at steps {rebuilds} ({n_train} views of "
          f"{cfg.error_map_size}^2), mIoU eval ({val_chunks} chunks) in "
          f"{dt:.2f} s; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    assert rebuilds and trainer.state.step == MASK_STEPS
    assert trainer.backbone_frozen
    per_pass = MASK_STEPS + em_chunks + val_chunks
    assert launches["K6"] == per_pass, (launches, per_pass)
    assert launches["K5"] == 2 * per_pass, (launches, per_pass)
    for k in ("K1", "K2", "K3", "K4", "K10"):
        assert launches[k] == 0, launches
    state = model.state_dict()
    for name, p in init.items():
        assert torch.equal(state[name].cpu(), p), f"backbone {name} moved"
    print(f"[stage3] backbone: all {len(init)} tensors bitwise equal to the "
          "init checkpoint", flush=True)
    with open(os.path.join(ws_dir, "log_ngp.txt")) as f:
        log = f.read()
    for s_ in rebuilds:
        assert f"[INFO] error map rebuilt at step {s_}\n" in log, log[-2000:]
    miou = float(log.split("[EVAL] MeanIoU = ")[-1].split()[0])
    hist = trainer.stats["mask"]
    assert all(np.isfinite(v["loss"]) for _, v in hist), hist
    (s_first, m_first), (s_last, m_last) = hist[0], hist[-1]
    print(f"[stage3] CE step {s_first} {m_first['ce']:.5f}, step {s_last} "
          f"{m_last['ce']:.5f} (loss {m_last['loss']:.5f}, ray_pair "
          f"{m_last['ray_pair']:.5f}, acc {m_last['acc']:.4f}); error map "
          f"rebuilt at steps {rebuilds}; [EVAL] MeanIoU {miou:.6f}",
          flush=True)

    # a batch as train_mask draws it, at the fovy-60 online camera
    dev = trainer.device
    res = cfg.online_resolution
    s_full = load_scene(scene, "llff")
    idx = split_indices(n_views, "train")
    masks_t = torch.as_tensor(
        np.stack([np.load(os.path.join(masks_dir, f"v{i:02d}_obj_mask.npy"))[0]
                  for i in idx]), dtype=torch.long, device=dev)
    poses_t = torch.as_tensor(s_full.poses[idx], device=dev)
    intr_t = torch.as_tensor(fixed_fovy_intrinsics(res, 60.0), device=dev)
    S = cfg.error_map_size
    error_map = torch.rand((len(idx), S * S), device=dev) + 0.05
    gen = torch.Generator(dev).manual_seed(3)

    def draw():
        return sample_mask_batch(gen, masks_t, poses_t, intr_t, error_map,
                                 cfg.num_rays, cfg.num_local_sample,
                                 cfg.local_sample_patch_size, res, res, S)

    # step rate: host clock around synchronised steps (past iters they only
    # see a lower lr)
    mask_step = make_mask_train_step(model, cfg, frozen_backbone=True)
    em = error_map
    for _ in range(3):
        _, em = mask_step(trainer.state, draw(), gen, em)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        m, em = mask_step(trainer.state, draw(), gen, em)
    torch.cuda.synchronize()
    sps = reps / (time.perf_counter() - t0)
    assert np.isfinite(float(m["loss"]))
    print(f"[stage3] {sps:.3f} steps/s at {n_rays} rays a step "
          f"({1e3 / sps:.2f} ms a step, mean of {reps} after 3 warm-up)",
          flush=True)

    # breakdown of one step's parts, each alone (CUDA events)
    batch = draw()
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps), use_contract=cfg.contract,
        min_near=cfg.min_near, background=cfg.background, bound=cfg.bound,
        training=True, return_mask=True, frozen_backbone=True)
    out, calls = capture_render(model, settings, batch)
    trainable = [p for p in model.parameters() if p.requires_grad]
    parts = {"sampler": cuda_ms(draw)}
    with torch.no_grad():
        for i, (a, k, _) in enumerate(calls["fused_prop_next_bins"]):
            parts[f"K5 level {i}"] = cuda_ms(
                lambda: model.fused_prop_next_bins(*a, **k))
        a, k, k6_out = calls["fused_final_render_frozen"][0]
        parts["K6"] = cuda_ms(lambda: model.fused_final_render_frozen(*a,
                                                                      **k))
    xyz = calls["mask_features"][0][0][0]
    w, geo = k6_out[3], k6_out[4]

    def branch(features):
        m_in = torch.cat([features(model, xyz), geo], dim=-1)
        logits = (w[..., None] * model.apply_mask_mlp(m_in)).sum(dim=-2)
        torch.autograd.grad(logits.square().sum(), trainable)

    parts["mask branch fwd+bwd"] = cuda_ms(
        lambda: branch(lambda mdl, x: mdl.mask_features(x)))
    logits = out["instance_mask_logits"].detach().requires_grad_()
    loss_in = dict(out, instance_mask_logits=logits)

    def losses():
        loss, _, _ = mask_losses(loss_in, batch, MASK_STEPS, em, cfg, gen)
        torch.autograd.grad(loss, logits)

    parts["losses fwd+bwd"] = cuda_ms(losses)
    step_ms = 1e3 / sps
    print("[stage3] parts of a step, each timed alone (ms; alone each also "
          "waits on its own launches, so they sum past the step): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; whole step {step_ms:.4f}", flush=True)
    profile = profile_steps(lambda: mask_step(trainer.state, draw(), gen,
                                              em))

    # the CP lookup as a one-hot matmul (the port) and as a gather
    with torch.no_grad():
        a_ = model.mask_features(xyz)
        b_ = gather_mask_features(model, xyz)
    lookup_err = rel_max(a_, b_)
    assert lookup_err < 1e-4, lookup_err
    lookup = {}
    for name, fn in (("onehot_matmul", lambda mdl, x: mdl.mask_features(x)),
                     ("gather", gather_mask_features)):
        def run(fn=fn):
            f = fn(model, xyz)
            torch.autograd.grad(f.square().sum(), [
                model.cp_m_x, model.cp_m_y, model.cp_m_z, model.cp_m_proj])
        lookup[name] = cuda_ms(run)
    print(f"[stage3] CP mask lookup fwd+bwd at {xyz.shape[0]}x{xyz.shape[1]} "
          f"points: one-hot matmul (the port) {lookup['onehot_matmul']:.4f} "
          f"ms, gather {lookup['gather']:.4f} ms (outputs rel-max "
          f"{lookup_err:.2e})", flush=True)

    # frozen route against the composable route on this batch
    gt = batch["gt_masks"][:cfg.num_rays]
    res_r = {}
    for route in (True, False):
        o = render_rays(model, batch["rays_o"], batch["rays_d"],
                        dataclasses.replace(settings, level_kernels=route))
        ce = torch.nn.functional.cross_entropy(
            o["instance_mask_logits"][:cfg.num_rays], gt)
        res_r[route] = (ce.item(), o["instance_mask_logits"].detach(),
                        torch.autograd.grad(ce, trainable))
    d_loss = abs(res_r[True][0] - res_r[False][0])
    d_logit = (res_r[True][1] - res_r[False][1]).abs().max().item()
    g_rel = max(rel_max(a, b_) for a, b_ in zip(res_r[True][2],
                                                res_r[False][2]))
    print(f"[stage3] frozen vs composable route, one batch: CE "
          f"{res_r[True][0]:.6f} vs {res_r[False][0]:.6f} (diff {d_loss:.2e}"
          f" < 2e-2), logits max abs {d_logit:.2e} (< 3e-2), trainable "
          f"grads worst rel-max {g_rel:.2e} (< 6e-2)", flush=True)
    assert d_loss < 2e-2 and d_logit < 3e-2 and g_rel < 6e-2

    reset_counts()
    tested = cli.main([scene, "--test", "--with_mask", "--mask_root",
                       masks_dir, "--field_type", "mlp", "--data_type",
                       "llff", "--workspace", ws_dir])
    test_launches = read_counts()
    assert tested.resumed and tested.state.step == MASK_STEPS
    assert test_launches["K6"] == val_chunks, test_launches
    for stem in ("v00", "v16"):
        probs = np.load(os.path.join(ws_dir, "results", f"{stem}_mask.npy"))
        assert probs.shape == (VIEW, VIEW, 2) and np.isfinite(probs).all()
        vis = read_png(os.path.join(ws_dir, "results", f"{stem}_mask_vis.png"))
        assert vis.shape == (VIEW, VIEW, 3)
    print(f"[stage3] --test --with_mask resumed at step {tested.state.step}; "
          "results/v00_mask.npy, v16_mask_vis.png written", flush=True)
    return launches, {"steps_per_s": sps, "rays_per_step": n_rays,
                      "miou": miou,
                      "ce_first": m_first["ce"], "ce_last": m_last["ce"],
                      "parts_alone_ms": parts, "profile": profile,
                      "cp_lookup_ms": lookup,
                      "route_loss_diff": d_loss,
                      "route_logit_max_abs": d_logit,
                      "route_grad_rel_max": g_rel}


def pdf_rows(dev, N, K, Q, seed):
    """K10 inputs: cdf, bins [N, K] non-decreasing with ties (flat cdf runs,
    half the rows clamped to 1 before their end, zero-width bins) and
    jittered stratified queries u [N, Q]."""
    g = torch.Generator(dev).manual_seed(seed)
    w = torch.rand(N, K - 1, generator=g, device=dev)
    w[torch.rand(N, K - 1, generator=g, device=dev) < 0.3] = 0.0
    cdf = torch.cumsum(w, -1)
    cdf = cdf / cdf[:, -1:].clamp_min(1e-12)
    cdf[: N // 2] *= 1.05
    cdf = torch.cat([torch.zeros(N, 1, device=dev), cdf.clamp_max(1.0)], -1)
    widths = torch.rand(N, K - 1, generator=g, device=dev)
    widths[torch.rand(N, K - 1, generator=g, device=dev) < 0.2] = 0.0
    bins = torch.cat([torch.zeros(N, 1, device=dev),
                      torch.cumsum(widths, -1)], -1)
    bins = bins / bins[:, -1:]
    u = stratified_queries(N, Q, dev, g).contiguous()
    return cdf.contiguous(), bins.contiguous(), u


def searchsorted_lookup(cdf, bins, u):
    """The lookup as torch.searchsorted, gathers and the arithmetic: timed
    beside K10 for information (no one PyTorch call computes it); the port
    does not call it."""
    K = cdf.shape[1]
    j = torch.searchsorted(cdf, u, right=True) - 1
    lo, hi = j.clamp_min(0), (j + 1).clamp_max(K - 1)
    neg = torch.tensor(-1e38, device=cdf.device)
    c0 = torch.where(j >= 0, cdf.gather(1, lo), neg)
    b0 = torch.where(j >= 0, bins.gather(1, lo), neg)
    c1, b1 = cdf.gather(1, hi), bins.gather(1, hi)
    denom = c1 - c0
    t = torch.where(denom > 0, (u - c0) / torch.where(denom > 0, denom, 1.0),
                    0.0).clamp(0.0, 1.0)
    return b0 + t * (b1 - b0)


def check_sample_pdf_kernel(dev):
    """Phase 3, K10 against its plain version at the render chunk and the
    training batch, both resampling shapes; the headline numbers are the
    chunk's, summed over the two shapes."""
    k10 = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "searchsorted_ms": 0.0, "bitwise_equal": True,
           "per_shape": {}}
    for N in (CHUNK, BATCH):
        for K, Q in ((129, 65), (65, 33)):
            cdf, bins, u = pdf_rows(dev, N, K, Q, seed=K)
            got = sample_pdf_lookup(cdf, bins, u)
            want = sample_pdf_lookup_ref(cdf, bins, u)
            comp = searchsorted_lookup(cdf, bins, u)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), "K10 output not finite"
            err = (got - want).abs().max().item()
            assert err <= 1e-6, f"K10 (N={N}, K={K}) max abs error {err}"
            equal = torch.equal(got, want)
            comp_err = (comp - want).abs().max().item()
            ties = int((cdf[:, 1:] == cdf[:, :-1]).sum().item())
            # the kernel takes a few us, its wrapper about as long on the
            # host: the device time from a graph, a call's from events
            ms = graph_ms(lambda: sample_pdf_lookup(cdf, bins, u))
            call_ms = cuda_ms(lambda: sample_pdf_lookup(cdf, bins, u))
            plain = cuda_ms(lambda: sample_pdf_lookup_ref(cdf, bins, u))
            ss = cuda_ms(lambda: searchsorted_lookup(cdf, bins, u))
            bms, by = bound(nbytes(cdf, bins, u, got), 0, 0)
            print(f"[kernel] K10 sample_pdf_lookup N={N} K={K} Q={Q}: max "
                  f"abs err {err:.3e} (<= 1e-6; bitwise equal {equal}; "
                  f"{ties} tied cdf steps), {ms:.4f} ms on the device "
                  f"({call_ms:.4f} ms a call from the host), plain version "
                  f"{plain:.4f} ms, searchsorted composite {ss:.4f} ms (err "
                  f"{comp_err:.1e}), bound {bms:.4f} ms ({by})", flush=True)
            k10["per_shape"][f"N{N}_K{K}_Q{Q}"] = {
                "ms": ms, "call_ms": call_ms, "plain_ms": plain,
                "searchsorted_ms": ss,
                "bound_ms": bms, "max_abs_err": err, "bitwise_equal": equal}
            k10["max_abs_err"] = max(k10["max_abs_err"], err)
            k10["bitwise_equal"] &= equal
            k10["bound_by"] = by
            if N == CHUNK:
                for key, v in (("ms", ms), ("call_ms", call_ms),
                               ("plain_ms", plain), ("bound_ms", bms),
                               ("searchsorted_ms", ss)):
                    k10[key] += v
    return k10


HG_GROUPS = (("K10", ("sample_pdf_lookup",)),
             ("gather and scatter-add (hash encode)", ("index",)),
             ("matrix products", ("gemm", "cutlass")),
             ("Adam", ("adam", "multi_tensor")))


def hashgrid_train_path(work):
    """Phase 8: the CLI with its default field at the published widths, 20
    steps of 8192 rays on the phase-4 scene; then the step rate with its
    breakdown, and a --test resuming the checkpoint with the render rate."""
    scene = os.path.join(work, "scene")
    ws_dir = os.path.join(work, "hg_ws")
    argv = [scene, "--data_type", "llff", "--workspace", ws_dir, "--seed",
            "0", "--iters", str(HG_STEPS), "--eval_cnt", "1", "--save_cnt",
            "1"]  # no --field_type: the default, hashgrid
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    model, cfg, n = trainer.model, trainer.cfg, trainer.state.step
    assert isinstance(model, SANeRFField) and not model.packed
    res = [m[0] for m in model.grid_spec.level_meta()]
    assert (res[0], res[-1], model.grid_spec.total_params) == (16, 4097,
                                                               6_299_960)
    assert [s_.total_params for s_ in model.prop_specs] == [383_264, 430_080]
    assert cfg.num_rays == BATCH and cfg.max_ray_batch == CHUNK
    assert tuple(cfg.num_steps) == (128, 64, 32) and n == HG_STEPS
    per_view = -(-VIEW * VIEW // CHUNK)
    eval_k10 = launches["K10"] - 2 * n
    views = eval_k10 // (2 * per_view)
    print(f"[hashgrid] CLI (default --field_type hashgrid, level "
          f"resolutions {res[0]}..{res[-1]}, {model.grid_spec.total_params} "
          f"+ {model.prop_specs[0].total_params} + "
          f"{model.prop_specs[1].total_params} table rows): {n} steps of "
          f"{cfg.num_rays} rays, {views} eval views, checkpoints in "
          f"{dt:.2f} s; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items()), flush=True)
    assert views > 0 and eval_k10 == 2 * per_view * views, launches
    for k in LEVEL_KERNELS:
        assert launches[k] == 0, launches
    losses = trainer.stats["loss"]
    assert losses and all(np.isfinite(losses)), losses
    ckpts = sorted(os.listdir(os.path.join(ws_dir, "checkpoints")))
    assert f"step_{n:08d}.pt" in ckpts and "best.pt" in ckpts, ckpts
    print(f"[hashgrid] losses by epoch {losses}; checkpoints {ckpts}",
          flush=True)

    # step rate: host clock around synchronised steps
    dev, state = trainer.device, trainer.state
    scene_t = train_tensors(scene, dev)
    gen = torch.Generator(dev).manual_seed(1)

    def draw():
        return sample_rgb_batch(gen, *scene_t, cfg.num_rays,
                                random_image_batch=cfg.random_image_batch)

    def step():
        return trainer.train_step(state, draw(), gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        m = step()
    torch.cuda.synchronize()
    sps = reps / (time.perf_counter() - t0)
    assert np.isfinite(float(m["loss"]))
    print(f"[hashgrid] {sps:.3f} steps/s at {cfg.num_rays} rays a step "
          f"({1e3 / sps:.2f} ms a step, mean of {reps} after 3 warm-up)",
          flush=True)
    parts = hashgrid_step_parts(trainer, draw, gen)
    print("[hashgrid] parts of a step, each timed alone (CUDA events, ms; "
          "alone each also waits on its own launches): " + ", ".join(
              f"{k} {v:.4f}" for k, v in parts.items())
          + f"; whole step {1e3 / sps:.4f}", flush=True)
    profile = profile_steps(step, HG_GROUPS)

    reset_counts()
    tested = cli.main([scene, "--test", "--data_type", "llff", "--workspace",
                       ws_dir])
    test_launches = read_counts()
    assert tested.resumed and tested.state.step == n, tested.state.step
    assert isinstance(tested.model, SANeRFField)
    assert test_launches["K10"] == 2 * 2 * per_view, test_launches
    for k in LEVEL_KERNELS:
        assert test_launches[k] == 0, test_launches
    for stem in ("v00", "v16"):
        img = read_png(os.path.join(ws_dir, "results", f"{stem}_rgb.png"))
        depth = np.load(os.path.join(ws_dir, "results", f"{stem}_depth.npy"))
        assert img.shape == (VIEW, VIEW, 3), img.shape
        assert depth.shape == (VIEW, VIEW) and np.isfinite(depth).all()
    pose = look_at_pose([2.0, 0.4, 0.0])
    focal = 0.5 * VIEW / np.tan(0.5 * np.deg2rad(50.0))
    intr = np.array([focal, focal, VIEW / 2, VIEW / 2], np.float32)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tested.render_view(pose, intr, VIEW, VIEW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    assert np.isfinite(out["image"]).all()
    mrays = VIEW * VIEW / float(np.median(times)) / 1e6
    print(f"[hashgrid] --test resumed at step {tested.state.step}, launches "
          f"K10 {test_launches['K10']} (2 a chunk, {2 * per_view} chunks); "
          f"render {mrays:.4f} Mrays/s ({VIEW}x{VIEW} view, median of 3, "
          f"{np.median(times) * 1e3:.2f} ms a view)", flush=True)
    return trainer, launches, {
        "steps_per_s": sps, "render_mrays_per_s": mrays,
        "train_launches": launches, "test_launches": test_launches,
        "parts_alone_ms": parts, "profile": profile,
        "loss_first_epoch": losses[0], "loss_last_epoch": losses[-1]}


def hashgrid_step_parts(trainer, draw, gen):
    """CUDA-event times of a hash-grid step's parts, each alone on one
    batch's own inputs: the sampler, the three hash encodes forward and
    backward, K10 at both levels, the MLPs forward and backward, the
    compositing and losses forward and backward at the step's shapes, and
    Adam over every parameter."""
    model, cfg = trainer.model, trainer.cfg
    batch = draw()
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps), use_contract=cfg.contract,
        min_near=cfg.min_near, background=cfg.background, bound=cfg.bound,
        perturb=True, training=True, compute_losses=True)
    lookups = []

    def spy_lookup(*a):
        lookups.append(a)
        return sample_pdf_lookup(*a)

    ray_ops.sample_pdf_lookup = spy_lookup
    try:
        out, calls = capture_render(model, settings, batch,
                                    ("density", "forward_color"), gen)
    finally:
        ray_ops.sample_pdf_lookup = sample_pdf_lookup
    assert len(lookups) == 2 and len(calls["density"]) == 2
    parts = {"sampler": cuda_ms(draw)}
    bound_ = model.grid_bound
    xs = [calls["density"][0][0][0].detach(), calls["density"][1][0][0]
          .detach(), calls["forward_color"][0][0][0].detach()]
    encodes = ((model.prop_grid_0, model.prop_specs[0], xs[0]),
               (model.prop_grid_1, model.prop_specs[1], xs[1]),
               (model.grid, model.grid_spec, xs[2]))
    feats = []
    for name, (table, spec, x) in zip(("proposal 0", "proposal 1", "main"),
                                      encodes):
        def enc(table=table, spec=spec, x=x):
            h = hash_encode(table, x, spec, bound=bound_)
            torch.autograd.grad(h.square().sum(), table)
        parts[f"hash encode fwd+bwd, {name} grid ({x.shape[0]}x"
              f"{x.shape[1]} points)"] = cuda_ms(enc)
        with torch.no_grad():
            feats.append(hash_encode(table, x, spec, bound=bound_))
    parts["K10, both levels (device time, CUDA graph)"] = graph_ms(
        lambda: [sample_pdf_lookup(*a) for a in lookups])
    mlp_params = [p for n_, p in model.named_parameters() if "mlp" in n_]
    feats = [f.requires_grad_() for f in feats]
    f_image = torch.randn(batch["rays_o"].shape[0], 31, device=xs[0].device,
                          requires_grad=True)

    def mlps():
        y = (model.prop_mlp_0(feats[0]).sum() + model.prop_mlp_1(feats[1])
             .sum() + model.grid_mlp(feats[2]).square().sum()
             + model.apply_view_mlp(f_image).sum())
        torch.autograd.grad(y, mlp_params + feats + [f_image])

    parts["MLPs fwd+bwd"] = cuda_ms(mlps)
    g = torch.Generator(xs[0].device).manual_seed(5)
    N = batch["rays_o"].shape[0]
    level_bins = [torch.sort(torch.rand(N, T + 1, generator=g,
                                        device=xs[0].device), -1).values
                  for T in cfg.num_steps]
    sigmas = [torch.rand(N, T, generator=g, device=xs[0].device)
              .requires_grad_() for T in cfg.num_steps]
    colors = torch.rand(N, cfg.num_steps[-1], 31, generator=g,
                        device=xs[0].device, requires_grad=True)

    def composite():
        ws = [compute_weights(b[:, 1:] - b[:, :-1], s_)[0]
              for b, s_ in zip(level_bins, sigmas)]
        f = (ws[-1][..., None] * colors).sum(-2)
        loss = (f.square().mean() + proposal_loss(level_bins, ws)
                + distort_loss(level_bins[-1], ws[-1]))
        torch.autograd.grad(loss, sigmas + [colors])

    parts["compositing and losses fwd+bwd"] = cuda_ms(composite)
    loss = trainer.train_step.loss_fn(batch, trainer.state.step, True,
                                      gen)[0]
    loss.backward()
    # repeated updates move the weights: timing only, after the step rate
    parts["Adam, every parameter"] = cuda_ms(trainer.state.optimizer.step)
    trainer.state.optimizer.zero_grad(set_to_none=True)
    return parts


def card_vs_cpu(trainer, scene):
    """Phase 8: one 1024-ray training batch through the same weights on the
    card and on the CPU.  The composable route's grads move at a one-ulp
    change of a cdf (the interlevel loss's band masks and clamps, and the
    far samples' spacing), and the two devices' cumsums round the cdf
    differently; so the CPU's render is handed the card's resampled bins
    (K10's outputs, each also held to the plain lookup on the CPU, bitwise
    equal expected) and held to image, depth and losses max abs <= 1e-3 and
    table grads rel-max <= 1e-3.  A second CPU render with its own lookups
    is held to the output bar and its grads' rel-L2 printed."""
    model, cfg, dev = trainer.model, trainer.cfg, trainer.device
    cpu = make_field("hashgrid", device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator(dev).manual_seed(4)
    batch = sample_rgb_batch(gen, *train_tensors(scene, dev), CPU_RAYS,
                             random_image_batch=True)
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps), use_contract=cfg.contract,
        min_near=cfg.min_near, background=cfg.background, bound=cfg.bound,
        training=True, compute_losses=True)

    def run(m, d, lookup):
        ray_ops.sample_pdf_lookup = lookup
        try:
            ro, rd = batch["rays_o"].to(d), batch["rays_d"].to(d)
            gt = batch["gt_rgb"][..., :3].to(d)
            out = render_rays(m, ro, rd, settings)
        finally:
            ray_ops.sample_pdf_lookup = sample_pdf_lookup
        losses = {"mse": torch.mean((out["image"] - gt) ** 2),
                  "proposal": out["proposal_loss"],
                  "distort": out["distort_loss"]}
        total = (losses["mse"] + cfg.lambda_proposal * losses["proposal"]
                 + cfg.lambda_distort * losses["distort"])
        grads = torch.autograd.grad(total, [m.grid, m.prop_grid_0,
                                            m.prop_grid_1])
        return ({k: out[k].detach().cpu() for k in
                 ("image", "depth", "weights_sum")},
                {k: v.item() for k, v in losses.items()},
                [g_.cpu() for g_ in grads])

    recorded = []

    def record(*a):
        out = sample_pdf_lookup(*a)
        recorded.append((a, out))
        return out

    replay_cdf_err = []

    def replay(cdf, bins, u):
        (c, b_, u_), out = recorded[len(replay_cdf_err)]
        replay_cdf_err.append((cdf - c.cpu()).abs().max().item())
        return out.cpu()

    card = run(model, dev, record)
    lookup_equal = all(torch.equal(sample_pdf_lookup_ref(*(x.cpu() for x in a)),
                                   out.cpu()) for a, out in recorded)
    handed = run(cpu, "cpu", replay)
    own = run(cpu, "cpu", sample_pdf_lookup_ref)

    def diffs(other):
        (oa, la, ga), (ob, lb, gb) = card, other
        out_err = {k: (oa[k] - ob[k]).abs().max().item() for k in oa}
        out_err.update({k: abs(la[k] - lb[k]) for k in la})
        g_max = {n_: rel_max(a, b_) for n_, a, b_ in
                 zip(("grid", "prop_grid_0", "prop_grid_1"), ga, gb)}
        g_l2 = {n_: ((a - b_).norm() / b_.norm().clamp_min(1e-30)).item()
                for n_, a, b_ in zip(("grid", "prop_grid_0", "prop_grid_1"),
                                     ga, gb)}
        return out_err, g_max, g_l2

    (h_out, h_gmax, _), (o_out, o_gmax, o_gl2) = diffs(handed), diffs(own)

    def fmt(d):
        return ", ".join(f"{k} {v:.2e}" for k, v in d.items())

    print(f"[hashgrid] card vs CPU, one {CPU_RAYS}-ray batch: K10's outputs "
          f"bitwise equal to the CPU's plain lookup on the same inputs "
          f"{lookup_equal}; the two cdfs max abs "
          f"{max(replay_cdf_err):.2e}. CPU handed the card's bins: max abs "
          f"{fmt(h_out)} (<= 1e-3); table grads rel-max {fmt(h_gmax)} (<= "
          f"1e-3). CPU on its own bins: max abs {fmt(o_out)} (<= 1e-3); "
          f"table grads rel-max {fmt(o_gmax)}, rel-L2 {fmt(o_gl2)}",
          flush=True)
    assert lookup_equal or all(
        (sample_pdf_lookup_ref(*(x.cpu() for x in a)) - out.cpu()).abs().max()
        <= 1e-6 for a, out in recorded)
    assert max(h_out.values()) <= 1e-3 and max(h_gmax.values()) <= 1e-3
    assert max(o_out.values()) <= 1e-3
    return {"lookup_bitwise_equal": lookup_equal,
            "cdf_max_abs": max(replay_cdf_err),
            "handed_bins": {"max_abs": h_out, "grad_rel_max": h_gmax},
            "own_bins": {"max_abs": o_out, "grad_rel_max": o_gmax,
                         "grad_rel_l2": o_gl2}}


def packed_path(work):
    """Phase 8: --field_type hashgrid_packed through the CLI, 5 steps of
    8192 rays (its main table is 8x the plain one)."""
    scene = os.path.join(work, "scene")
    ws_dir = os.path.join(work, "packed_ws")
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main([scene, "--field_type", "hashgrid_packed",
                        "--data_type", "llff", "--workspace", ws_dir,
                        "--seed", "0", "--iters", str(PACKED_STEPS),
                        "--eval_cnt", "1", "--save_cnt", "1"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    model = trainer.model
    assert model.packed and model.grid.shape == (6_299_960, 16)
    assert trainer.state.step == PACKED_STEPS
    assert trainer.cfg.num_rays == BATCH
    losses = trainer.stats["loss"]
    assert losses and all(np.isfinite(losses)), losses
    assert launches["K10"] > 2 * PACKED_STEPS, launches
    for k in LEVEL_KERNELS:
        assert launches[k] == 0, launches
    mb = model.grid.numel() * 4 / 2 ** 20
    print(f"[packed] CLI --field_type hashgrid_packed: {PACKED_STEPS} steps "
          f"of {trainer.cfg.num_rays} rays and its evals in {dt:.2f} s, main "
          f"table {tuple(model.grid.shape)} ({mb:.1f} MiB); losses {losses}; "
          f"launches K10 {launches['K10']}", flush=True)
    return {"seconds": dt, "losses": losses, "launches": launches}


def main():
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 twins stay fp32
    torch.backends.cudnn.allow_tf32 = False
    dev_line = device_line()
    print(dev_line, flush=True)

    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    print(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a: "
          f"{sorted(logs) or 'up to date'} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    field = make_field("mlp", device="cuda", seed=0, grid_bound=2.0,
                       cp_rank=64, cp_res=256)
    with torch.inference_mode():
        kernels = check_kernels(field)
        kernels.update(check_train_kernels(field))
        kernels["K10"] = check_sample_pdf_kernel(torch.device("cuda"))
    kernels["K3"]["train_shape_ms"] = kernels.pop("K3_train_ms")
    launches, mrays = main_path(work)
    trainer, train_launches, sps = train_path(work)
    parity = grad_parity(trainer, os.path.join(work, "scene"))
    s3_launches, s3 = stage3_path(work, os.path.join(work, "train_ws"))
    hg_trainer, hg_launches, hg = hashgrid_train_path(work)
    hg["card_vs_cpu"] = card_vs_cpu(hg_trainer, os.path.join(work, "scene"))
    hg["packed"] = packed_path(work)

    # K5, K1, K2 and K10 numbers are the sums over both levels (per_shape
    # has each); K5 and K3 launches are the inference path's, K1, K2 and
    # K4 the training path's (K3 also ran there once a step), K6 the
    # stage-3 path's, K10 the hash-grid training path's
    rows = (("K5", "fused_prop_level_sample", SOURCE, 258, launches),
            ("K3", "fused_final_level", SOURCE, 695, launches),
            ("K6", "fused_final_level_frozen", SOURCE, 143, s3_launches),
            ("K1", "fused_prop_level_sample_train", SOURCE, 415,
             train_launches),
            ("K2", "fused_prop_level_bwd", SOURCE_BWD, 861, train_launches),
            ("K4", "fused_final_level_bwd", SOURCE_BWD, 754, train_launches))
    report = [{"name": name, "route": "cuda", "source": src,
               "replaces": f"{TPU_FILE}:{line}", "launches": counts[kid],
               "library_ms": None, **kernels[kid]}
              for kid, name, src, line, counts in rows]
    report.append({"name": "sample_pdf_lookup", "route": "cuda",
                   "source": SOURCE_PDF, "replaces": f"{TPU_FILE_PDF}:69",
                   "launches": hg_launches["K10"], "library_ms": None,
                   **kernels["K10"]})
    print(json.dumps({"kernels": report, "render_mrays_per_s": mrays,
                      "train_steps_per_s": sps,
                      "train_launches": train_launches,
                      "grad_parity_worst_rel_l2": max(parity.values()),
                      "stage3_launches": s3_launches, "stage3": s3,
                      "hashgrid": hg}))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
