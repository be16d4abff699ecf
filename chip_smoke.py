#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`sanerf_hq_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py           # every phase
    python3 chip_smoke.py --ab      # phases 1 and 2, the level kernels'
                                    # output digests and K8's check alone

`--ab` is what an A/B call runs on each of two commits: copied into an
earlier commit's checkout, it measures that commit's package the same way
(the design lines of K8 are left out where its module has no design rule).

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
       K3's; K5 and K6 also timed at a 6256-ray stage-3 batch; K3's parts
       on the chunk, each beside its plain part and its bound: the trunk's
       input (h_in rel-max < 2e-2), the four layer products (rel-max < 2e-2,
       the fp32 last layer < 1e-4; torch's bf16 matmul of the same
       operands timed beside each) and the compositing (rel-max < 2e-2),
       and the peak device memory a chunk's K3 call adds;
     - training, one 8192-ray batch with random cotangents: K1 at both
       proposal levels (bins max abs <= 1e-3 and equal to K5's, weights
       rel-max < 2e-2), K2 at T = 128 and 64 and K4 at T = 32 (rel-max
       < 2e-2 on every weight and CP grad; the weight grads bitwise equal
       over two launches; K4's CP grads, summed with atomics, print their
       run-to-run difference); K7 at both proposal levels (weights rel-max
       < 2e-2, bitwise equal to K1's; prop_level_train's weight grads
       bitwise equal to prop_level_train_sample's under one cotangent);
     - the level kernels' output digests (sha256 of K5, K1, K7, K2, K3,
       K6 and K4's outputs on this phase's shapes and fixed seeds), which
       an A/B call compares across commits where shared device code moved;
     - K8 (freq encode + MLP forward) at the composable route's shapes of
       a 6256-ray stage-3 batch: the proposal MLP at 800,768 and 400,384
       points (the narrow design) and the cp_rank-0 trunk at 200,192 (the
       wide design), with the design the wrapper's rule takes, rel-max <
       2e-2 on the outputs and on the autograd grads of x and every weight,
       two launches bitwise equal, timed with its wrapper and on the device
       alone (CUDA graph) beside its plain version, a sin/cos + bf16
       F.linear composite and the weights' bf16 conversions as PyTorch
       launches; at the trunk the wide design's peak device memory and its
       parts, each beside its plain part and its bound: the weight pack
       (bitwise), the input kernel and each layer product (torch's bf16
       matmul of the same operands beside each);
     - the parts of K2 and K4 on the training batch, each beside its plain
       part: K2's partial slabs (their sum rel-max < 2e-2 against the twin)
       and their reduction in CTA order (rel-max < 1e-5 against
       part.sum(0)) at each level; K4's stash of the weight products'
       operands (rel-L2 < 1e-2 an operand against final_level_bwd_operands,
       CP grads rel-max < 2e-2) and its weight-grad GEMM (rel-max < 1e-4
       against d^T x in fp32 on the same stash; torch's bf16 matmul of the
       same pairs timed beside it);
  4. inference path: a synthetic llff scene written under build/, the
     port's CLI `--test` on it at flagship width with a seeded field (2
     views of 512x512, 16 chunks each), with the launch counts set to 0
     just before and read just after: K5 must launch twice a chunk and K3
     once; then the render rate, and the level-kernel route against the
     composable route on a 128x128 view (max abs < 2e-2; the composable
     render launches K8 twice);
  5. training path: the port's CLI without --test on the same scene at
     flagship width, 20 steps of 8192 rays, counts set to 0 just before and
     read just after: per step K1 twice, K2 twice (every step <= 3000
     updates the proposal MLPs), K3 once and K4 once (K3 and K5 also run in
     the eval renders), K7 and K8 never; a finite loss, checkpoints on disk, a later --test
     resuming from them, and the train step rate (host clock around
     synchronised steps), and, traced after phase 9 (see 10), the step's
     device time by kernel (K1, K2, K3's input, products and compositing,
     K4's three GEMMs beside their bounds and its other kernels, the
     reductions, the rest) and idle
     share from one device-only torch.profiler trace; K2's and K4's parts
     launch once a call each;
  6. grad parity: on one 8192-ray batch at step 2000 (distortion ramp fully
     on, so K4's weights grad carries gradient), the level-kernel route's
     grads against the composable route's (K8 forwards, autograd through
     the plain field), per-leaf rel-L2 <= 5%;
  7. stage 3: analytic sphere masks in the decode output format, then the
     CLI with --with_mask --init_ckpt <phase-5 workspace> and the flags of
     scripts/train_obj_nerf.sh (6000 rays and four 8x8 patches a step, 200
     steps, the ray-pair loss from step 150, the error map at 128), counts
     set to 0 just before and read just after: K5 twice and K6 once a step,
     a chunk and an error-map view, K1-K4, K7, K8 never; the backbone bitwise equal
     to the init checkpoint, the error map rebuilt at step 150, the CE at
     the first and last step, [EVAL] MeanIoU; then the step rate (host
     clock around synchronised steps) and its breakdown (CUDA events: the
     sampler, K5, K6, the mask branch forward and backward, the losses;
     one device-only torch.profiler trace, taken in 10), the CP feature
     lookup as a one-hot matmul and as a gather, the frozen
     route against the composable route on one batch (CE within 2e-2,
     logits within 3e-2, trainable grads rel-max < 6e-2; the composable
     render launches K8 twice), and a --test --with_mask resuming the
     field;
  8. the hash-grid field (the CLI default, at the published widths): K10
     (inverse-CDF lookup) against its plain version at N = 16384 and 8192
     with (K, Q) = (129, 65) and (65, 33) on rows with ties, max abs <=
     1e-6, timed beside a searchsorted composite (this check runs with
     phase 3); the CLI without --field_type, 20 steps of 8192 rays on the
     phase-4 scene, counts set to 0 just before and read just after: K10
     twice a step and twice an eval chunk, K1-K8 never; a finite loss,
     checkpoints, the step rate with its breakdown (CUDA events: the
     sampler, the three hash encodes forward and backward, K10, the MLPs,
     compositing and losses, Adam; one device-only torch.profiler trace,
     taken in 10); a --test resuming it (K10 twice a chunk) and the render rate; the
     card against the CPU on one 1024-ray batch with the same weights
     (the CPU handed the card's resampled bins: image, depth, losses max
     abs <= 1e-3, table grads rel-max <= 1e-3; on its own bins the output
     bar, grads printed);
     then --field_type hashgrid_packed, 5 steps of 8192 rays;
  9. stage 3 with a trainable backbone: the CLI with the phase-7 flags and
     masks but no --init_ckpt (the backbone from --seed), 200 steps of 6256
     rays, counts set to 0 just before and read just after: K8 twice a
     step (the proposal MLPs of the composable route), K10 twice a step,
     K5 and K6 only in the error-map and eval renders, K1-K4 and K7 never;
     backbone_frozen False, the CE at the first and last step, [EVAL]
     MeanIoU, the peak device memory; the step rate (host clock around
     synchronised steps) with its breakdown (CUDA events: the sampler, K8
     with its wrapper and on the device alone, K10, the plain CP trunk,
     compositing, the mask branch, the losses, Adam; one device-only
     torch.profiler trace, taken in 10, K8's narrow kernel by name); then
     20 steps with --cp_rank 0, where K8 also runs the trunk through its
     wide design: three launches a step, and its trace (K8 narrow, the wide
     design's pack and input kernels, its layer products);
 11. the scripts' path (run before 10's traces): a COLMAP scene in the
     Mip-NeRF 360 layout (write_colmap_scene: 15 training views and 2
     held out, images_4/ at 512x512, images/ and the PINHOLE camera at
     2048x2048, sparse points on the sphere) and sphere masks at
     2048x2048; the flags of scripts/train_rgb_nerf.sh, train_obj_nerf.sh
     and test_obj_nerf.sh read out of the scripts (script_argv), the
     relative --test_view_path replaced by the absolute path of the file
     written here; counts set to 0 just before and read just after each
     CLI run:
     1. stage 1 (--enable_cam_center --downscale 4 --data_type mip
        --contract --random_image_batch), --iters 20 (cut from 5000): K10
        twice a step and an eval chunk, K1-K9 never; a finite loss,
        checkpoints, the per-view near/far of the sparse points;
     2. stage 3 of the hash-grid object field (m_grid 16 x 8 at 2^19)
        over step 1's workspace, 200 steps of 6256 rays: K10 twice a step,
        an error-map chunk and an eval chunk (2048x2048), K1-K9 never; the
        backbone bitwise equal to step 1's checkpoint, m_grid and mask_mlp
        moved; the CE at the first and last step, the error-map rebuild,
        [EVAL] MeanIoU, the peak device memory; then the step rate (host
        clock around synchronised steps) and its parts (CUDA events: the
        sampler, the backbone's forward, K10, the m_grid encode forward and
        backward, the mask MLP forward and backward, the losses with TV /
        WD off and with --lambda_tv 1e-4, Adam; one device-only
        torch.profiler trace, taken in 10);
     3. the stage-3 --test: K10 twice a chunk, {stem}_mask.npy and
        _mask_vis.png of both held-out views;
     4. 20 stage-3 steps with --mask_mlp_type lightweight_mask (m_grid 16 x
        2 at 2^10, unpacked) and 5. with --field_type hashgrid_packed over
        a 5-step packed stage 1, their evals at --downscale 4;
     6. 20 steps of --field_type mlp --feat_rep hashgrid --with_mask
        --init_ckpt <phase-5 workspace> on the phase-4 scene: K5 twice and
        K6 once a step and an eval chunk, K1-K4, K7, K8, K10 never, the
        backbone bitwise kept;
     7. the card against the CPU on 1024 global rays of a stage-3 batch
        with the same weights, the CPU handed the card's resampled bins:
        the loss and instance_mask_logits max abs <= 1e-3, the m_grid and
        mask_mlp grads rel-max <= 1e-3.
 10. the device-only torch.profiler traces of phases 5, 7, 8, 9 and 11,
     taken after every rate, since a trace slows the host's later steps;
     one JSON line with every kernel's numbers (K10's launches those of
     phases 8 and 11's stage 3) and the phases' summaries (11's under
     "scripts_path"), the device line again, and the last line {"ok":
     true, "device": {...}}.
"""
import dataclasses
import hashlib
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data.png import read_png
from sanerf_hq_tpu_torch.data.provider import (load_scene, resize_nearest,
                                               split_indices)
from sanerf_hq_tpu_torch.data.rays import full_frame_rays
from sanerf_hq_tpu_torch.data.sampler import (fixed_fovy_intrinsics,
                                              sample_mask_batch,
                                              sample_rgb_batch)
from sanerf_hq_tpu_torch.data.synthetic import (look_at_pose,
                                                write_colmap_scene,
                                                write_llff_scene,
                                                write_sphere_masks)
from sanerf_hq_tpu_torch.models import SANeRFField, make_field, mlp_field
from sanerf_hq_tpu_torch.models.fields import lightweight_mask_grid_spec
from sanerf_hq_tpu_torch.ops import cuda_lib, fused_mlp
from sanerf_hq_tpu_torch.ops import ray as ray_ops
from sanerf_hq_tpu_torch.ops import render_level as rl
from sanerf_hq_tpu_torch.ops.composite import (compute_weights, distort_loss,
                                               proposal_loss)
from sanerf_hq_tpu_torch.ops.contraction import contract
from sanerf_hq_tpu_torch.ops.fused_mlp import fused_freq_mlp
from sanerf_hq_tpu_torch.ops.hashgrid import hash_encode
from sanerf_hq_tpu_torch.ops.ray import (near_far_from_aabb, spacing_fn,
                                         spacing_fn_inv, stratified_queries)
from sanerf_hq_tpu_torch.ops.sample_pdf import (sample_pdf_lookup,
                                                sample_pdf_lookup_ref)
from sanerf_hq_tpu_torch.ops.sh import sh_encode
from sanerf_hq_tpu_torch.render.renderer import RenderSettings, render_rays
from sanerf_hq_tpu_torch.train.checkpoints import CheckpointManager
from sanerf_hq_tpu_torch.train.steps import (_grid_regularizers,
                                             make_mask_train_step,
                                             make_rgb_train_step, mask_losses)

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "sanerf_hq_tpu_torch/csrc/render_level.cu"
SOURCE_BWD = "sanerf_hq_tpu_torch/csrc/render_level_bwd.cu"
SOURCE_GEMM = "sanerf_hq_tpu_torch/csrc/render_level_gemm.cuh"
SOURCE_PDF = "sanerf_hq_tpu_torch/csrc/sample_pdf.cu"
SOURCE_MLP = "sanerf_hq_tpu_torch/csrc/fused_mlp.cu"
TPU_FILE = "sanerf_hq_tpu/ops/render_level_pallas.py"
TPU_FILE_PDF = "sanerf_hq_tpu/ops/sample_pdf_pallas.py"
TPU_FILE_MLP = "sanerf_hq_tpu/ops/fused_mlp.py"
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
CP0_STEPS = 20  # stage-3 steps with a trainable backbone at cp_rank 0
COUNTERS = {"K5": rl.fused_prop_level_sample, "K3": rl.fused_final_level,
            "K6": rl.fused_final_level_frozen,
            "K1": rl.fused_prop_level_sample_train,
            "K2": rl.fused_prop_level_bwd, "K4": rl.fused_final_level_bwd,
            "K7": rl.fused_prop_level, "K8": fused_freq_mlp,
            "K10": sample_pdf_lookup,
            # the parts of K2 and K4: each call of K2 or K4 launches each
            # of its parts once
            "K2.partials": rl.prop_level_bwd_partials,
            "K2.reduce": rl.reduce_partials,
            "K4.stash": rl.final_level_bwd_stash,
            "K4.gemm": rl.weight_grads}
PARTS = {"K2": ("K2.partials", "K2.reduce"), "K4": ("K4.stash", "K4.gemm")}
LEVEL_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def script_argv(name, env):
    """The arguments that `scripts/<name>` passes to `python main.py`, read
    out of the script, its ${VARIABLES} taken from env (a KeyError names
    one env lacks) and its trailing "$@" dropped: the flag sets the port's
    CLI runs as the scripts give them."""
    with open(os.path.join(ROOT, "scripts", name)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(l for l in text.splitlines()
                if l.strip().startswith("python main.py"))
    words = shlex.split(line)[2:]
    return [re.sub(r"\$\{(\w+)\}", lambda m: env[m.group(1)], w)
            for w in words if w != "$@"]


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
    # the peak device memory one K3 call adds at a chunk: its scratch (xb,
    # a1, a3 bf16; f, xn fp32) and outputs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rl.fused_final_level(*call, **args3)
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated() - held) / 2**30
    print(f"[kernel] K3 at a {N}-ray chunk adds {scratch:.4f} GiB of peak "
          "device memory (scratch and outputs)", flush=True)
    results["K3"]["peak_memory_gib"] = scratch
    results["K3"]["parts"] = final_fwd_parts(call, args3, got)
    results["K6"] = check_frozen_kernel(field, call, args3, got)
    return results


def final_fwd_parts(call, args3, k3_out):
    """K3's three kernels on the chunk, each against its plain part and
    beside its bound: the trunk's input; the four layer products on the
    operands the kernels give each other (each beside torch's bf16 matmul
    of the same operands, a yardstick the port does not call); and the
    compositing of the last product's output (its outputs against the
    plain part; the weights K3 wrote, bitwise)."""
    ro, rd, real, sh, ws = call
    cps, res = args3["cps"], args3["cp_res"]
    deg, gb = args3["freq_degree"], args3["grid_bound"]
    N, T = ro.shape[0], real.shape[1] - 1
    P, H, nin = N * T, ws[1].shape[0], ws[0].shape[1]
    kin = rl._round16(nin)
    rows = {}

    h_in, xn = rl.final_level_inputs(ro, rd, real, deg, gb, cps, res,
                                     hidden=H)
    want_h, _ = rl.final_level_inputs_ref(ro, rd, real, deg, gb, cps, res)
    torch.cuda.synchronize()
    err = (h_in[:, :nin].float() - want_h).abs().max().item()
    rel = rel_max(h_in[:, :nin].float(), want_h)
    assert rel < 2e-2, f"K3 inputs rel-max {rel}"
    del want_h
    ms = cuda_ms(lambda: rl.final_level_inputs(ro, rd, real, deg, gb, cps,
                                               res, hidden=H))
    plain = cuda_ms(lambda: rl.final_level_inputs_ref(ro, rd, real, deg, gb,
                                                      cps, res))
    bms, by = bound(nbytes(ro, rd, real, *cps, h_in, xn), 0,
                    2 * P * 3 * deg)
    print(f"[kernel] K3 part final_level_inputs: rel-max {rel:.3e} (< 2e-2), "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by})",
          flush=True)
    rows.update((part_row("final_level_inputs", f"{TPU_FILE}:695", ms, plain,
                          bms, by, err, source=SOURCE),))

    # the products on the kernels' own operands: h_in a column slice of
    # the [A2 | h_in] rows, as K3 reads it
    w0 = rl._bf16_padded(ws[0], H, kin)
    w2 = rl._bf16_padded(ws[2], H, H + kin)
    w1, w3 = (w.to(torch.bfloat16).contiguous() for w in (ws[1], ws[3]))
    xb = torch.zeros(P, H + kin, dtype=torch.bfloat16, device=ro.device)
    xb[:, H:H + h_in.shape[1]] = h_in
    del h_in
    a1 = rl.layer_product(xb[:, H:], w0)
    xb[:, :H] = rl.layer_product(a1, w1)
    a3 = rl.layer_product(xb, w2)
    layers = (("A1", xb[:, H:], w0, True), ("A2", a1, w1, True),
              ("A3", xb, w2, True), ("F", a3, w3, False))
    for name, x, w, relu in layers:
        got = rl.layer_product(x, w, relu)
        want = rl.layer_product_ref(x, w, relu)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        rel = rel_max(got.float(), want)
        bar = 2e-2 if relu else 1e-4
        assert rel < bar, f"K3 product {name} rel-max {rel}"
        del want
        ms = cuda_ms(lambda: rl.layer_product(x, w, relu))
        plain = cuda_ms(lambda: rl.layer_product_ref(x, w, relu))
        lib = cuda_ms(lambda: x @ w.t())
        bms, by = bound(nbytes(x, w, got), 2 * P * x.shape[1] * w.shape[0],
                        0)
        print(f"[kernel] K3 product {name} [{P} x {x.shape[1]}] x "
              f"[{x.shape[1]} x {w.shape[0]}]: rel-max {rel:.3e} "
              f"(< {bar:g}), {ms:.4f} ms, plain {plain:.4f} ms, torch bf16 "
              f"matmul {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        rows.update((part_row(f"layer_product {name}", f"{TPU_FILE}:695", ms,
                              plain, bms, by, err, lib,
                              source=SOURCE_GEMM),))
    f = got
    del xb, a1, a3

    out = rl.final_composite(f, real, sh, args3["opaque_last"],
                             args3["density_bias"])
    ref = rl.final_composite_ref(f, real, sh, args3["opaque_last"],
                                 args3["density_bias"])
    torch.cuda.synchronize()
    rels = [rel_max(a, b) for a, b in zip(out[:4], ref[:4])]
    assert max(rels) < 2e-2, f"K3 compositing rel-max {rels}"
    assert torch.equal(out[3], k3_out[3]), "the weights differ from K3's"
    err = max((a - b).abs().max().item() for a, b in zip(out[:4], ref[:4]))
    ms = cuda_ms(lambda: rl.final_composite(f, real, sh))
    plain = cuda_ms(lambda: rl.final_composite_ref(f, real, sh))
    bms, by = bound(nbytes(f, real, sh, *out[:4]), 0, 0)
    print(f"[kernel] K3 part final_composite: rel-max {max(rels):.3e} "
          f"(< 2e-2), weights bitwise K3's, {ms:.4f} ms, plain {plain:.4f} "
          f"ms, bound {bms:.4f} ms ({by})", flush=True)
    rows.update((part_row("final_composite", f"{TPU_FILE}:695", ms, plain,
                          bms, by, err, source=SOURCE),))
    return rows


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
    k2_parts = {}
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
        add_parts(k2_parts, prop_bwd_parts(
            bcall, pargs, want, 2 * pts * macs,
            2 * pts * 3 * field.prop_freq_degree, plain2))
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
    k4["parts"], k4["gemm_bounds"] = final_bwd_parts(call, fargs, ws, rank)
    k2["parts"] = k2_parts
    # K3, the training forward, at the same 8192-ray shape
    k3 = cuda_ms(lambda: rl.fused_final_level(ro, rd, real, sh, ws, **fargs))
    print(f"[kernel] K3 fused_final_level at the training shape (8192 rays, "
          f"T=32): {k3:.4f} ms", flush=True)
    return {"K1": k1, "K2": k2, "K4": k4, "K3_train_ms": k3}


PART_KEYS = ("ms", "plain_ms", "bound_ms")


def add_parts(total, parts):
    """Sums per-level parts into total (K2 runs at two levels)."""
    for name, part in parts.items():
        if name not in total:
            total[name] = dict(part)
            continue
        t = total[name]
        for k in PART_KEYS + ("library_ms",):
            if t.get(k) is not None:
                t[k] += part[k]
        t["max_abs_err"] = max(t["max_abs_err"], part["max_abs_err"])


def part_row(name, what, ms, plain, bms, by, err, library=None,
             source=SOURCE_BWD):
    return name, {"name": name, "route": "cuda", "source": source,
                  "replaces": what, "ms": ms, "plain_ms": plain,
                  "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                  "library_ms": library}


def prop_bwd_parts(bcall, pargs, want, flops, fp32_ops, plain):
    """K2's two kernels on one level's batch: the partial slabs (their sum
    against the twin; the twin is their plain part, as one slab) and the
    reduction in CTA order (against part.sum(0))."""
    ws = bcall[3]
    H = ws[1].shape[0]
    kin = rl._round16(ws[0].shape[1])
    part = rl.prop_level_bwd_partials(*bcall, **pargs)
    d0, d1, d2 = part.sum(0).split([H * kin, H * H, 16 * H])
    got = (d0.view(H, kin)[:, :ws[0].shape[1]], d1.view(H, H),
           d2.view(16, H)[:1])
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    rels = [rel_max(a, b) for a, b in zip(got, want)]
    assert max(rels) < 2e-2, f"K2 partials rel-max {rels}"
    red = rl.reduce_partials(part)
    plain_red = part.sum(0)
    torch.cuda.synchronize()
    red_err = (red - plain_red).abs().max().item()
    assert rel_max(red, plain_red) < 1e-5, "K2 reduction"
    ms_p = cuda_ms(lambda: rl.prop_level_bwd_partials(*bcall, **pargs))
    ms_r = cuda_ms(lambda: rl.reduce_partials(part))
    plain_r = cuda_ms(lambda: part.sum(0))
    bms_p, by_p = bound(nbytes(*bcall[:3], *ws, bcall[4], part), flops,
                        fp32_ops)
    bms_r, by_r = bound(nbytes(part, red), 0, part.numel())
    print(f"[kernel] K2 parts at T={bcall[2].shape[1] - 1}: partials "
          f"({part.shape[0]} slabs) rel-max {max(rels):.3e}, {ms_p:.4f} ms, "
          f"bound {bms_p:.4f} ms ({by_p}); reduction max abs {red_err:.3e}, "
          f"{ms_r:.4f} ms, plain {plain_r:.4f} ms, bound {bms_r:.4f} ms "
          f"({by_r})", flush=True)
    return dict((part_row("prop_level_bwd_partials", f"{TPU_FILE}:861", ms_p,
                          plain, bms_p, by_p, err),
                 part_row("reduce_partials", f"{TPU_FILE}:1126", ms_r,
                          plain_r, bms_r, by_r, red_err)))


def final_bwd_parts(call, fargs, ws, rank):
    """K4's two parts at the flagship batch: the stash of the weight
    products' operands (against final_level_bwd_operands: rel-L2 < 1e-2 for
    each operand, since an activation within a rounding of 0 can flip its
    relu mask; CP grads rel-max < 2e-2) and the weight-grad GEMM (against
    d^T x in fp32 on the same stash: rel-max < 1e-4, as both sum exact
    bf16 products in fp32; beside it, torch's bf16 matmul of the same
    pairs, which rounds its output to bf16)."""
    pairs, dcps = rl.final_level_bwd_stash(*call, **fargs)
    want, want_c = rl.final_level_bwd_operands(*call, **fargs)
    torch.cuda.synchronize()
    l2 = 0.0
    for l, ((d, x), (wd, wx)) in enumerate(zip(pairs, want)):
        for name, a, b in (("d", d[:, :wd.shape[1]], wd),
                           ("x", x[:, :wx.shape[1]], wx)):
            r = ((a.float() - b).norm() / b.norm().clamp_min(1e-12)).item()
            assert r < 1e-2, f"K4 stash {name}{l} rel-L2 {r}"
            l2 = max(l2, r)
    cp_rel = max([rel_max(a, b) for a, b in zip(dcps, want_c)] or [0.0])
    assert cp_rel < 2e-2, f"K4 stash CP grads rel-max {cp_rel}"
    err = max([(a - b).abs().max().item() for a, b in zip(dcps, want_c)]
              + [(p[0][:, :w[0].shape[1]].float() - w[0]).abs().max().item()
                 for p, w in zip(pairs, want)])
    del want
    got = rl.weight_grads(pairs)
    ref = rl.weight_grads_ref(pairs)
    torch.cuda.synchronize()
    g_rel = max(rel_max(a, b) for a, b in zip(got, ref))
    g_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    assert g_rel < 1e-4, f"weight-grad GEMM rel-max {g_rel}"
    ms_s = cuda_ms(lambda: rl.final_level_bwd_stash(*call, **fargs))
    plain_s = cuda_ms(lambda: rl.final_level_bwd_operands(*call, **fargs))
    ms_g = cuda_ms(lambda: rl.weight_grads(pairs))
    plain_g = cuda_ms(lambda: rl.weight_grads_ref(pairs))
    lib_g = cuda_ms(lambda: [d.t() @ x for d, x in pairs])
    H = ws[1].shape[0]
    pts = call[0].shape[0] * (call[2].shape[1] - 1)
    # forward (the trunk's MACs) + dA (as K4's bound); the stash's bytes
    # are written once
    macs = mlp_macs(ws) + ws[3].numel() + (H + rank) * H + H * H + rank * H
    stash = nbytes(*(d for d, _ in pairs), pairs[1][1], pairs[2][1],
                   pairs[3][1])  # d0..d3, A1, [A2 | h_in], A3
    bms_s, by_s = bound(nbytes(*call[:4], *ws, *fargs["cps"], *call[5:],
                               *dcps) + stash, 2 * pts * macs,
                        2 * pts * 3 * fargs["freq_degree"])
    gmacs = sum(d.shape[1] * x.shape[1] for d, x in pairs)
    bms_g, by_g = bound(stash + nbytes(*got), 2 * pts * gmacs, 0)
    # the stash kernels' GEMMs alone: the forward products read each
    # layer's input and write its output (A1, A2, A3 bf16, F [P, 16]
    # fp32); the dA products read d3..d0 and the relu masks A3, A2, A1,
    # and write d2..d0 and the CP columns' grad [P, rank] fp32
    (d0, h_in), (d1, a1), (d2, xb), (d3, a3) = pairs
    a2 = H * pts * 2
    fwd = bound(nbytes(h_in, a1, xb, a3, *ws) + nbytes(a1, a3) + a2
                + pts * 16 * 4, 2 * pts * mlp_macs(ws), 0)
    dmacs = ws[3].numel() + (H + rank) * H + H * H + rank * H
    dab = bound(nbytes(d3, d2, d1, d0, a3, a1, *ws) + a2
                + nbytes(d2, d1, d0) + pts * rank * 4, 2 * pts * dmacs, 0)
    gemm_bounds = {"K4 forward products": fwd, "K4 dA products": dab,
                   "K4 weight-grad GEMM": (bms_g, by_g)}
    print(f"[kernel] K4 parts: stash ({stash / 2**30:.3f} GiB) operands "
          f"rel-L2 <= {l2:.3e} (< 1e-2), CP grads rel-max {cp_rel:.3e}, "
          f"{ms_s:.4f} ms, plain {plain_s:.4f} ms, bound {bms_s:.4f} ms "
          f"({by_s}); weight-grad GEMM rel-max {g_rel:.3e} (< 1e-4), "
          f"{ms_g:.4f} ms, plain (fp32 matmul) {plain_g:.4f} ms, torch bf16 "
          f"matmul {lib_g:.4f} ms, bound {bms_g:.4f} ms ({by_g})", flush=True)
    return dict((part_row("final_level_bwd_stash", f"{TPU_FILE}:754", ms_s,
                          plain_s, bms_s, by_s, err),
                 part_row("weight_grads", f"{TPU_FILE}:1059", ms_g, plain_g,
                          bms_g, by_g, g_err, lib_g))), gemm_bounds


def check_prop_weights_kernel(field):
    """Phase 3, K7 on the K1 batch (8192 rays) at both proposal levels:
    against its twin, its weights bitwise equal to K1's, and the grads of
    prop_level_train (forward K7, backward K2) bitwise equal to those of
    prop_level_train_sample (forward K1, backward K2) under one random
    cotangent.  The headline numbers are sums over the two levels."""
    dev = field.cp_x.device
    ro, rd = view_rays(dev, 64, 128)
    N = ro.shape[0]
    assert N == BATCH
    sn, sf = s_space(ro, rd)
    g = torch.Generator(dev).manual_seed(7)
    pargs = dict(freq_degree=field.prop_freq_degree,
                 grid_bound=field.grid_bound, opaque_last=True,
                 density_bias=field.density_bias)
    k7 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
          "equal_to_K1": True, "grads_equal_to_K1_K2": True,
          "per_shape": {}}
    s_bins = torch.linspace(0.0, 1.0, 129, device=dev).expand(N, 129)
    s_bins = s_bins.contiguous()
    for level, (T, Q) in enumerate(((128, 65), (64, 33))):
        real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
        u = stratified_queries(N, Q, dev).contiguous()
        ws = (field.prop_mlp_0 if level == 0 else field.prop_mlp_1).weights
        with torch.inference_mode():
            w = rl.fused_prop_level(ro, rd, real, ws, **pargs)
            w_ref = rl.prop_level_ref(ro, rd, real, ws, **pargs)
            w1, nb = rl.fused_prop_level_sample_train(ro, rd, real, s_bins,
                                                      u, ws, **pargs)
            torch.cuda.synchronize()
            assert torch.isfinite(w).all(), "K7 weights not finite"
            rel = rel_max(w, w_ref)
            err = (w - w_ref).abs().max().item()
            assert rel < 2e-2, f"K7 (T={T}) weights rel-max error {rel}"
            assert torch.equal(w, w1), f"K7 (T={T}) weights differ from K1's"
            ms = cuda_ms(lambda: rl.fused_prop_level(ro, rd, real, ws,
                                                     **pargs))
            plain = cuda_ms(lambda: rl.prop_level_ref(ro, rd, real, ws,
                                                      **pargs))
        g_w = torch.randn(N, T, generator=g, device=dev)
        grads = []
        for fn in (lambda p: rl.prop_level_train(ro, rd, real, p, **pargs),
                   lambda p: rl.prop_level_train_sample(
                       ro, rd, real, s_bins, u, p, **pargs)[0]):
            p = [x.detach().clone().requires_grad_() for x in ws]
            grads.append(torch.autograd.grad((fn(p) * g_w).sum(), p))
        torch.cuda.synchronize()
        for i, (a, b_) in enumerate(zip(*grads)):
            assert torch.equal(a, b_), f"prop_level_train dW{i} (T={T})"
        pts = N * T
        bms, by = bound(nbytes(ro, rd, real, *ws, w), 2 * pts * mlp_macs(ws),
                        2 * pts * 3 * field.prop_freq_degree)
        print(f"[kernel] K7 fused_prop_level T={T}: weights rel-max err "
              f"{rel:.3e} (< 2e-2), bitwise equal to K1's; prop_level_train "
              f"grads bitwise equal to prop_level_train_sample's; {ms:.4f} "
              f"ms, plain twin {plain:.4f} ms, bound {bms:.4f} ms ({by})",
              flush=True)
        k7["per_shape"][f"T{T}"] = {"ms": ms, "plain_ms": plain,
                                   "bound_ms": bms, "max_abs_err": err,
                                   "rel_max_err": rel}
        k7["ms"] += ms
        k7["plain_ms"] += plain
        k7["bound_ms"] += bms
        k7["bound_by"] = by
        k7["max_abs_err"] = max(k7["max_abs_err"], err)
        s_bins = nb.clone()  # a normal tensor: it reaches autograd
    return k7


def path_points(dev, T, grid_bound, n=MASK_BATCH):
    """The composable route's MLP input at one level of a stage-3 batch:
    contract(xyz) / grid_bound of n view rays at T uniform s-space samples,
    [n * T, 3]."""
    ro, rd = view_rays(dev, 64, 128)
    ro, rd = ro[:n], rd[:n]
    sn, sf = s_space(ro, rd)
    s_ = torch.linspace(0.0, 1.0, T + 1, device=dev)
    real = spacing_fn_inv(sn * (1.0 - s_) + sf * s_)
    t = (real[:, 1:] + real[:, :-1]) * 0.5
    xyz = contract(ro[:, None, :] + rd[:, None, :] * t[..., None])
    return (xyz / grid_bound).reshape(-1, 3).contiguous()


def composite_mlp(x, ws_bf16, deg, skip):
    """K8's function as PyTorch calls: the freq encoding (torch.sin,
    torch.cos), then a chain of bf16 F.linear (cuBLAS) with the ReLUs, the
    last output cast to fp32.  Timed beside K8 for information (no one
    PyTorch call computes it); the port does not call it."""
    h = fused_mlp._freq(x, deg).to(torch.bfloat16)
    h_in = h
    for l, w in enumerate(ws_bf16):
        if l == skip:
            h = torch.cat([h, h_in], dim=-1)
        h = F.linear(h, w)
        if l != len(ws_bf16) - 1:
            h = torch.relu(h)
    return h.float()


def check_mlp_kernel(field, trunk):
    """Phase 3, K8 at the composable route's shapes of a 6256-ray stage-3
    batch: the proposal MLPs at 128 and 64 samples a ray and the cp_rank-0
    trunk (`trunk`) at 32.  At each shape: the design the wrapper's rule
    takes, the output against the twin and two launches bitwise equal, the
    autograd grads against autograd through the twin, the time with the
    wrapper (CUDA events around each call) and on the device alone (a CUDA
    graph of the calls), beside the twin, the sin/cos + bf16 F.linear
    composite, the bf16 weight conversions the first port's wrapper ran on
    every call (2 PyTorch launches a layer), and the bound; at the trunk the
    wide design's peak device memory and its parts (mlp_wide_parts).  The
    headline numbers are the sums over the two proposal shapes (a step's K8
    work at CP rank 64).  Over a package without the design rule (an
    earlier commit's, for an A/B comparison) the design lines are left
    out."""
    dev = field.cp_x.device
    design_of = getattr(fused_mlp, "mlp_design", None)
    k8 = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "composite_ms": 0.0, "conversions_ms": 0.0, "max_abs_err": 0.0,
          "bitwise_equal": True, "per_shape": {}}
    for name, T, mlp in (("proposal", 128, field.prop_mlp_0),
                         ("proposal", 64, field.prop_mlp_1),
                         ("trunk", 32, trunk)):
        ws, deg, skip = mlp.weights, mlp.freq_degree, mlp.skip_layer
        x = path_points(dev, T, field.grid_bound)
        B = x.shape[0]
        nin = 3 * (1 + 2 * deg)
        kin = rl._round16(nin)
        design = (design_of(len(ws), ws[0].shape[0], nin, kin,
                            ws[-1].shape[0], skip)
                  if design_of else "one kernel")
        with torch.inference_mode():
            got = fused_freq_mlp(x, ws, deg, skip)
            again = fused_freq_mlp(x, ws, deg, skip)
            want = fused_mlp._reference_forward(x, ws, deg, skip)
            wb = [w.to(torch.bfloat16) for w in ws]
            comp = composite_mlp(x, wb, deg, skip)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), f"K8 {name} output not finite"
            rel = rel_max(got, want)
            err = (got - want).abs().max().item()
            assert rel < 2e-2, f"K8 {name} at {B} points rel-max error {rel}"
            equal = torch.equal(got, again)
            assert equal, f"K8 {name}: two launches differ"
            comp_rel = rel_max(comp, want)
            ms = cuda_ms(lambda: fused_freq_mlp(x, ws, deg, skip))
            gms = graph_ms(lambda: fused_freq_mlp(x, ws, deg, skip))
            plain = cuda_ms(lambda: fused_mlp._reference_forward(x, ws, deg,
                                                                skip))
            cms = cuda_ms(lambda: composite_mlp(x, wb, deg, skip))
            conv = cuda_ms(lambda: [
                rl._bf16_padded(w, rl._round16(w.shape[0]),
                                rl._round16(w.shape[1])) for w in ws])
            peak = None
            if name == "trunk":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                fused_freq_mlp(x, ws, deg, skip)
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        cot = torch.randn(got.shape, generator=torch.Generator(dev)
                          .manual_seed(T), device=dev)
        grads = []
        for fn in (fused_freq_mlp, fused_mlp._reference_forward):
            leaves = [t.detach().clone().requires_grad_() for t in [x] + ws]
            y = fn(leaves[0], leaves[1:], deg, skip)
            grads.append(torch.autograd.grad(y, leaves, cot))
        torch.cuda.synchronize()
        g_rels = [rel_max(a, b_) for a, b_ in zip(*grads)]
        assert max(g_rels) < 2e-2, f"K8 {name} grads rel-max {g_rels}"
        macs = mlp_macs(ws)
        bms, by = bound(nbytes(x, *ws, got), 2 * B * macs, 2 * B * 3 * deg)
        print(f"[kernel] K8 fused_freq_mlp {name} ({len(ws)} layers, skip "
              f"{skip}, {macs} MAC a point) at {B} points, design {design}: "
              f"rel-max err {rel:.3e} (< 2e-2), two launches bitwise equal "
              f"{equal}, grads of x and the weights rel-max "
              f"{max(g_rels):.3e} (< 2e-2); {ms:.4f} ms a call with its "
              f"wrapper, {gms:.4f} ms on the device alone (CUDA graph), "
              f"plain twin {plain:.4f} ms, sin/cos + bf16 F.linear composite "
              f"{cms:.4f} ms (rel-max {comp_rel:.1e}), the weights' bf16 "
              f"conversions as PyTorch launches {conv:.4f} ms, bound "
              f"{bms:.4f} ms ({by})"
              + ("" if peak is None else
                 f"; adds {peak:.4f} GiB of peak device memory"), flush=True)
        shape = {"design": design, "ms": ms, "graph_ms": gms,
                 "plain_ms": plain, "composite_ms": cms,
                 "conversions_ms": conv, "bound_ms": bms, "bound_by": by,
                 "max_abs_err": err, "rel_max_err": rel,
                 "grad_rel_max": max(g_rels), "bitwise_equal": equal,
                 "mac_per_point": macs}
        if peak is not None:
            shape["peak_memory_gib"] = peak
        if name == "trunk" and design == "wide":
            shape["parts"] = mlp_wide_parts(x, ws, deg, skip)
        k8["per_shape"][f"{name}_N{B}"] = shape
        k8["max_abs_err"] = max(k8["max_abs_err"], err)
        k8["bitwise_equal"] &= equal
        if name == "proposal":
            for key, v in (("ms", ms), ("graph_ms", gms), ("plain_ms", plain),
                           ("bound_ms", bms), ("composite_ms", cms),
                           ("conversions_ms", conv)):
                k8[key] += v
            k8["bound_by"] = by
            k8["design"] = design
    return k8


def mlp_wide_parts(x, ws, deg, skip):
    """K8's wide design at the trunk's shape, part by part, each against
    its plain part and beside its bound, as final_fwd_parts does for K3:
    the weight pack (bitwise equal to pack_weights_ref), the input kernel
    (rel-max < 2e-2 against trunk_input) and each layer's product on the
    operands the kernels give each other (rel-max < 2e-2, the fp32 last
    layer < 1e-4; torch's bf16 matmul of the same operands beside each, a
    yardstick the port does not call)."""
    L, H, out_dim = len(ws), ws[0].shape[0], ws[-1].shape[0]
    B, nin = x.shape[0], 3 * (1 + 2 * deg)
    kin = rl._round16(nin)
    c0 = H if skip > 0 else 0
    src = f"{TPU_FILE_MLP}:213"
    rows = {}

    def report(part, got_ok, err, what, ms, plain, bms, by, lib=None):
        print(f"[kernel] K8 wide part {part}: {what}, {ms:.4f} ms, plain "
              f"{plain:.4f} ms" + ("" if lib is None else
                                   f", torch bf16 matmul {lib:.4f} ms")
              + f", bound {bms:.4f} ms ({by})", flush=True)
        assert got_ok, f"K8 wide part {part}: {what}"
        rows.update((part_row(part, src, ms, plain, bms, by, err, lib,
                              source=SOURCE_MLP),))

    wp = fused_mlp.pack_weights(ws, deg, skip)
    ref = fused_mlp.pack_weights_ref(ws, nin, kin, skip)
    torch.cuda.synchronize()
    equal = torch.equal(wp, ref)
    ms = cuda_ms(lambda: fused_mlp.pack_weights(ws, deg, skip))
    plain = cuda_ms(lambda: fused_mlp.pack_weights_ref(ws, nin, kin, skip))
    bms, by = bound(nbytes(*ws, wp), 0, 0)
    report("pack_weights", equal, 0.0 if equal else float("inf"),
           f"bitwise equal to its plain version {equal}", ms, plain, bms, by)

    h = fused_mlp.freq_input(x, deg, c0)
    want = fused_mlp.trunk_input(x, deg)
    torch.cuda.synchronize()
    rel = rel_max(h[:, :nin].float(), want)
    err = (h[:, :nin].float() - want).abs().max().item()
    ms = cuda_ms(lambda: fused_mlp.freq_input(x, deg, c0))
    plain = cuda_ms(lambda: fused_mlp.trunk_input(x, deg))
    bms, by = bound(nbytes(x, h), 0, 2 * B * 3 * deg)
    report("freq_input", rel < 2e-2, err, f"rel-max {rel:.3e} (< 2e-2)", ms,
           plain, bms, by)

    # the products on the kernels' own operands, as the wide design chains
    # them (fused_mlp.wide_plan): h_in a column slice of the [A | h_in] rows
    offs = fused_mlp.packed_offsets(L, H, nin, kin, out_dim, skip)
    shapes = fused_mlp.layer_shapes(L, H, nin, kin, out_dim, skip)
    xb = torch.zeros(B, c0 + kin, dtype=torch.bfloat16, device=x.device)
    xb[:, c0:] = h
    del h
    cur = None
    for l, (n, _, k) in enumerate(shapes):
        w = wp[offs[l]:offs[l + 1]].view(n, k)
        xl = xb if l == skip else (xb[:, c0:] if l == 0 else cur)
        relu = l != L - 1
        got = rl.layer_product(xl, w, relu)
        want = rl.layer_product_ref(xl, w, relu)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        rel = rel_max(got.float(), want)
        bar = 2e-2 if relu else 1e-4
        del want
        ms = cuda_ms(lambda: rl.layer_product(xl, w, relu))
        plain = cuda_ms(lambda: rl.layer_product_ref(xl, w, relu))
        lib = cuda_ms(lambda: xl @ w.t())
        bms, by = bound(nbytes(xl, w, got), 2 * B * k * n, 0)
        report(f"layer_product {l} [{B} x {k}] x [{k} x {n}]", rel < bar,
               err, f"rel-max {rel:.3e} (< {bar:g})", ms, plain, bms, by, lib)
        if relu and l + 1 == skip:
            xb[:, :H] = got
        cur = got
    return rows


def level_digests(field):
    """sha256 (16 hex digits) of the level kernels' outputs on phase 3's
    shapes, with the seeded field, the chunk's (16384) and the training
    batch's (8192) view rays, and queries and cotangents from fixed seeds:
    K5 and K1 at both proposal levels (K1's bins and weights), K7, K2's
    weight grads, K3 and K6 (all outputs) and K4's weight grads (its CP
    grads are summed with atomics and left out).  Builds whose device code
    computes alike give equal digests: an A/B call compares them across
    commits (--ab)."""
    dev = field.cp_x.device
    out = {}

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    pargs = dict(freq_degree=field.prop_freq_degree,
                 grid_bound=field.grid_bound, opaque_last=True,
                 density_bias=field.density_bias)
    args3 = dict(freq_degree=field.freq_degree, skip_layer=2,
                 grid_bound=field.grid_bound, opaque_last=True,
                 density_bias=field.density_bias, cps=field.cp_basis,
                 cp_res=field.cp_res)
    for N, (vh, vw) in ((CHUNK, (128, 128)), (BATCH, (64, 128))):
        ro, rd = view_rays(dev, vh, vw)
        sn, sf = s_space(ro, rd)
        s_bins = torch.linspace(0.0, 1.0, 129, device=dev).expand(N, 129)
        s_bins = s_bins.contiguous()
        for level, (T, Q) in enumerate(((128, 65), (64, 33))):
            real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
            u = stratified_queries(N, Q, dev, torch.Generator(dev)
                                   .manual_seed(level)).contiguous()
            ws = (field.prop_mlp_0 if level == 0 else field.prop_mlp_1).weights
            nb = rl.fused_prop_level_sample(ro, rd, real, s_bins, u, ws,
                                            **pargs)
            out[f"K5 N{N} T{T}"] = digest(nb)
            out[f"K1 N{N} T{T}"] = digest(*rl.fused_prop_level_sample_train(
                ro, rd, real, s_bins, u, ws, **pargs))
            out[f"K7 N{N} T{T}"] = digest(rl.fused_prop_level(ro, rd, real, ws,
                                                              **pargs))
            g_w = torch.randn(N, T, generator=torch.Generator(dev)
                              .manual_seed(10 + level), device=dev)
            out[f"K2 N{N} T{T}"] = digest(*rl.fused_prop_level_bwd(
                ro, rd, real, ws, g_w, **pargs))
            s_bins = nb
        real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
        sh = sh_encode(rd / torch.linalg.norm(rd, dim=-1, keepdim=True))
        ws = field.trunk.weights
        k3 = rl.fused_final_level(ro, rd, real, sh, ws, **args3)
        out[f"K3 N{N}"] = digest(*k3)
        k6 = rl.fused_final_level_frozen(ro, rd, real, sh, ws, need_geo=True,
                                         **args3)
        out[f"K6 N{N}"] = digest(*k6)
        gen = torch.Generator(dev).manual_seed(20)
        T = real.shape[1] - 1
        cots = [torch.randn(shape, generator=gen, device=dev)
                for shape in ((N, 31), (N,), (N,), (N, T))]
        dws, _ = rl.fused_final_level_bwd(ro, rd, real, sh, ws, *cots,
                                          **args3)
        out[f"K4 N{N}"] = digest(*dws)
    torch.cuda.synchronize()
    print("[kernel] level kernels' output digests (sha256, 16 hex digits): "
          + ", ".join(f"{k} {v}" for k, v in out.items()), flush=True)
    return out


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
    assert launches["K7"] == launches["K8"] == 0, launches
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
        reset_counts()
        b = render_rays(trainer.model, ro, rd,
                        RenderSettings(level_kernels=False))
        composable = read_counts()
    print(f"[main] composable route launches: K8 {composable['K8']}, K10 "
          f"{composable['K10']}", flush=True)
    assert composable["K8"] == 2 and composable["K10"] == 2, composable
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
    for kid, parts in PARTS.items():
        assert all(launches[k] == launches[kid] for k in parts), launches
    assert launches["K5"] > 0 and launches["K5"] % 2 == 0, launches
    assert launches["K3"] == n + launches["K5"] // 2, launches
    assert launches["K10"] == 0, launches
    assert launches["K7"] == launches["K8"] == 0, launches
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
    return trainer, launches, sps, step


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
    grads, k8 = {}, {}
    for route in (True, False):
        loss_fn = make_rgb_train_step(model, cfg, perturb=False,
                                      level_kernels=route).loss_fn
        reset_counts()
        loss, _ = loss_fn(batch, 2000, True)
        grads[route] = torch.autograd.grad(loss, params)
        k8[route] = fused_freq_mlp.launches
    print(f"[parity] K8 launches: kernel route {k8[True]}, composable route "
          f"{k8[False]}", flush=True)
    assert k8 == {True: 0, False: 2}, k8
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


# K3 (and K6) and K4 launch the same input kernel and forward products
# (render_level_gemm.cuh); profile_steps marks each run of them "k3:" or
# "k4:" by the compositing kernel that ends it
SHARED_KERNELS = ("final_input_kernel", "layer_gemm<0>", "layer_gemm<1>")
OWNER_KERNELS = (("final_forward_composite", "k3:"),
                 ("final_composite_kernel", "k4:"))
# device kernels of the stage-1 step by source kernel (first match wins):
# K4's three GEMMs (the forward products, EPI_RELU and EPI_F32; the dA
# products, EPI_MASK; the weight-grad GEMM) and its other kernels (input,
# compositing, CP grads); K2's kernel; the split/slab reductions both
# launch; K1 (K5's kernel); K3's input, products and compositing
K4_GEMMS = (("K4 forward products", ("k4:layer_gemm<0>", "k4:layer_gemm<1>")),
            ("K4 dA products", ("layer_gemm<2>",)),
            ("K4 weight-grad GEMM", ("weight_grad_gemm",)))
K3_PARTS = (("K3 input", ("k3:final_input_kernel",)),
            ("K3 products", ("k3:layer_gemm",)),
            ("K3 compositing", ("final_forward_composite",)))
STAGE1_GROUPS = K4_GEMMS + K3_PARTS + (
                 ("K4 other", ("k4:final_input_kernel",
                               "final_composite_kernel", "final_cp_kernel")),
                 ("K2", ("prop_level_bwd_kernel",)),
                 ("K2/K4 reductions", ("reduce_partials",)),
                 ("K1", ("prop_level_sample_kernel",)))
STAGE3_GROUPS = (("K5", ("prop_level_sample_kernel",)),
                 ("K6", ("k3:", "final_forward_composite")),
                 ("matrix products", ("gemm", "cutlass")))


def owned_names(events):
    """Lower-case names of the device events, each kernel of
    SHARED_KERNELS marked with its owner's tag: a call of K3 or K4 runs
    them in a row on one stream, and then its own compositing kernel; a
    call of K8's wide design runs its input kernel and then its layer
    products (tagged "k8:")."""
    names = [e.name.lower() for e in events]
    pending, k8 = [], False
    for i in sorted(range(len(events)),
                    key=lambda i: events[i].time_range.start):
        shared = next((k for k in SHARED_KERNELS if k in names[i]), None)
        if shared and k8:
            names[i] = names[i].replace(shared, "k8:" + shared)
            continue
        if shared:
            pending.append((i, shared))
            continue
        k8 = "fused_freq_mlp_input" in names[i]
        tag = next((t for k, t in OWNER_KERNELS if k in names[i]), None)
        if tag:
            for j, k in pending:
                names[j] = names[j].replace(k, tag + k)
            pending = []
    return names


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
    # the device's own events: kernels, copies, memsets
    for e, name in zip(events, owned_names(events)):
        ms = e.time_range.elapsed_us() / 1e3 / n
        g = next((g for g, subs in kinds if any(x in name for x in subs)),
                 "other")
        groups[g] += ms
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + ms
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
    for k in ("K1", "K2", "K3", "K4", "K7", "K8", "K10"):
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
    res_r, k8 = {}, {}
    for route in (True, False):
        reset_counts()
        o = render_rays(model, batch["rays_o"], batch["rays_d"],
                        dataclasses.replace(settings, level_kernels=route))
        k8[route] = fused_freq_mlp.launches
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
    print(f"[stage3] K8 launches: frozen route {k8[True]}, composable route "
          f"{k8[False]}", flush=True)
    assert k8 == {True: 0, False: 2}, k8

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
                      "parts_alone_ms": parts,
                      "trace": (lambda: mask_step(trainer.state, draw(), gen,
                                                  em), STAGE3_GROUPS),
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
    for k in LEVEL_KERNELS + ("K8",):
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

    reset_counts()
    tested = cli.main([scene, "--test", "--data_type", "llff", "--workspace",
                       ws_dir])
    test_launches = read_counts()
    assert tested.resumed and tested.state.step == n, tested.state.step
    assert isinstance(tested.model, SANeRFField)
    assert test_launches["K10"] == 2 * 2 * per_view, test_launches
    for k in LEVEL_KERNELS + ("K8",):
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
        "parts_alone_ms": parts, "trace": (step, HG_GROUPS),
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
    for k in LEVEL_KERNELS + ("K8",):
        assert launches[k] == 0, launches
    mb = model.grid.numel() * 4 / 2 ** 20
    print(f"[packed] CLI --field_type hashgrid_packed: {PACKED_STEPS} steps "
          f"of {trainer.cfg.num_rays} rays and its evals in {dt:.2f} s, main "
          f"table {tuple(model.grid.shape)} ({mb:.1f} MiB); losses {losses}; "
          f"launches K10 {launches['K10']}", flush=True)
    return {"seconds": dt, "losses": losses, "launches": launches}


TRAINABLE_GROUPS = (("K8 narrow", ("fused_freq_mlp_narrow",)),
                    ("K8 wide: weight pack and input", (
                        "fused_freq_mlp_pack", "fused_freq_mlp_input")),
                    ("K8 wide: layer products", ("k8:layer_gemm",)),
                    ("K10", ("sample_pdf_lookup",)),
                    ("matrix products", ("gemm", "cutlass")),
                    ("Adam", ("adam", "multi_tensor")))


def stage3_trainable_path(work):
    """Phase 9: stage 3 through the CLI with the phase-7 flags and masks
    but no --init_ckpt, so the backbone (from --seed) is trainable and the
    mask step renders through the composable route; its step rate and
    breakdown; then CP0_STEPS steps at cp_rank 0."""
    scene = os.path.join(work, "scene")
    masks_dir = os.path.join(work, "masks")  # written by phase 7
    ws_dir = os.path.join(work, "obj_trainable_ws")
    n_views = 17
    argv = [scene, "--field_type", "mlp", "--data_type", "llff",
            "--workspace", ws_dir, "--seed", "0", "--with_mask",
            "--mask_root", masks_dir, "--num_rays", "6000",
            "--iters", str(MASK_STEPS), "--ray_pair_rgb_loss_weight", "1",
            "--ray_pair_rgb_threshold", "0.1", "--ray_pair_rgb_iter", "150",
            "--ray_pair_rgb_num_sample", "8", "--local_sample_patch_size",
            "8", "--num_local_sample", "4", "--mixed_sampling",
            "--random_image_batch", "--error_map"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg, model = trainer.cfg, trainer.model
    n_train = n_views - 2
    n_rays = (cfg.num_rays
              + cfg.num_local_sample * cfg.local_sample_patch_size ** 2)
    rebuilds = [s_ for s_ in range(1, MASK_STEPS + 1)
                if s_ % cfg.ray_pair_rgb_iter == 0]
    val_chunks = 2 * -(-VIEW * VIEW // cfg.max_ray_batch)
    em_chunks = len(rebuilds) * n_train * -(-cfg.error_map_size ** 2
                                             // cfg.max_ray_batch)
    print(f"[trainable] CLI --with_mask, no --init_ckpt (cp_rank "
          f"{model.cp_rank}): {trainer.state.step} steps of {n_rays} rays, "
          f"error-map rebuilds at {rebuilds}, mIoU eval in {dt:.2f} s; peak "
          f"device memory {peak:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    assert trainer.state.step == MASK_STEPS and not trainer.backbone_frozen
    per_pass = em_chunks + val_chunks
    assert launches["K8"] == 2 * MASK_STEPS, launches
    assert launches["K10"] == 2 * MASK_STEPS, launches
    assert launches["K6"] == per_pass, (launches, per_pass)
    assert launches["K5"] == 2 * per_pass, (launches, per_pass)
    for k in ("K1", "K2", "K3", "K4", "K7"):
        assert launches[k] == 0, launches
    # no loss term reaches the backbone (weights, features and image are
    # read detached, as in JAX): only the mask branch moves from the seeded
    # weights, which the EMA (never updated in stage 3) still holds
    ema = dict(trainer.state.ema_model.named_parameters())
    moved = sorted(n_ for n_, p in model.named_parameters()
                   if not torch.equal(p, ema[n_]))
    assert moved and all(n_.startswith(("cp_m_", "mask_mlp"))
                         for n_ in moved), moved
    with open(os.path.join(ws_dir, "log_ngp.txt")) as f:
        log = f.read()
    assert "init checkpoint" not in log
    miou = float(log.split("[EVAL] MeanIoU = ")[-1].split()[0])
    hist = trainer.stats["mask"]
    assert all(np.isfinite(v["ce"]) and np.isfinite(v["loss"])
               for _, v in hist), hist
    (s_first, m_first), (s_last, m_last) = hist[0], hist[-1]
    print(f"[trainable] backbone_frozen {trainer.backbone_frozen}; moved "
          f"from the seeded weights: {len(moved)} mask-branch tensors, no "
          f"backbone tensor; CE step "
          f"{s_first} {m_first['ce']:.5f}, step {s_last} {m_last['ce']:.5f} "
          f"(loss {m_last['loss']:.5f}, acc {m_last['acc']:.4f}); [EVAL] "
          f"MeanIoU {miou:.6f}", flush=True)

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
    gen = torch.Generator(dev).manual_seed(6)
    em = torch.rand((len(idx), S * S), device=dev) + 0.05

    def draw():
        return sample_mask_batch(gen, masks_t, poses_t, intr_t, em,
                                 cfg.num_rays, cfg.num_local_sample,
                                 cfg.local_sample_patch_size, res, res, S)

    mask_step = make_mask_train_step(model, cfg, frozen_backbone=False)

    def step():
        return mask_step(trainer.state, draw(), gen, em)[0]

    sps = steps_per_s(step)
    print(f"[trainable] {sps:.3f} steps/s at {n_rays} rays a step "
          f"({1e3 / sps:.2f} ms a step, mean of 20 after 3 warm-up) on "
          f"{device_line()}", flush=True)
    parts = trainable_step_parts(trainer, draw, gen, em)
    print("[trainable] parts of a step, each timed alone (CUDA events, ms; "
          "alone each also waits on its own launches): " + ", ".join(
              f"{k} {v:.4f}" for k, v in parts.items())
          + f"; whole step {1e3 / sps:.4f} ({device_line()})", flush=True)

    # cp_rank 0: the trunk has no CP features and runs K8 too
    ws0 = os.path.join(work, "obj_trainable_cp0_ws")
    argv0 = [a if a != ws_dir else ws0 for a in argv]
    argv0[argv0.index("--iters") + 1] = str(CP0_STEPS)
    reset_counts()
    t0 = time.perf_counter()
    trainer0 = cli.main(argv0 + ["--cp_rank", "0"])
    torch.cuda.synchronize()
    dt0 = time.perf_counter() - t0
    launches0 = read_counts()
    assert trainer0.model.cp_rank == 0 and not trainer0.backbone_frozen
    assert trainer0.state.step == CP0_STEPS
    assert launches0["K8"] == 3 * CP0_STEPS, launches0
    assert launches0["K10"] == 2 * CP0_STEPS, launches0
    assert launches0["K6"] == val_chunks, launches0
    for k in ("K1", "K2", "K3", "K4", "K7"):
        assert launches0[k] == 0, launches0
    hist0 = trainer0.stats["mask"]
    assert all(np.isfinite(v["ce"]) for _, v in hist0), hist0
    step0 = make_mask_train_step(trainer0.model, trainer0.cfg,
                                 frozen_backbone=False)
    sps0 = steps_per_s(lambda: step0(trainer0.state, draw(), gen, em)[0])
    print(f"[trainable] cp_rank 0: {CP0_STEPS} CLI steps and the eval in "
          f"{dt0:.2f} s, launches " + ", ".join(
              f"{k} {v}" for k, v in launches0.items())
          + f"; CE step {hist0[0][0]} {hist0[0][1]['ce']:.5f}, step "
          f"{hist0[-1][0]} {hist0[-1][1]['ce']:.5f}; {sps0:.3f} steps/s on "
          f"{device_line()}", flush=True)
    return launches, {"steps_per_s": sps, "rays_per_step": n_rays,
                      "peak_memory_gib": peak, "miou": miou,
                      "ce_first": m_first["ce"], "ce_last": m_last["ce"],
                      "parts_alone_ms": parts,
                      "trace": (step, TRAINABLE_GROUPS),
                      "cp0": {"launches": launches0, "steps_per_s": sps0,
                              "trace": (lambda: step0(trainer0.state, draw(),
                                                      gen, em)[0],
                                        TRAINABLE_GROUPS),
                              "ce_first": hist0[0][1]["ce"],
                              "ce_last": hist0[-1][1]["ce"]}}


def steps_per_s(step, reps=20):
    """Host clock around `reps` synchronised steps after 3 warm-up steps."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        m = step()
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))
    return reps / (time.perf_counter() - t0)


def trainable_step_parts(trainer, draw, gen, em):
    """CUDA-event times of a trainable-backbone mask step's parts, each
    alone on one batch's own inputs: the sampler, K8 at both proposal
    levels, K10 at both levels, the plain CP trunk forward (forward_color,
    with its autograd graph, as the step builds it), compositing and the
    view MLP forward, the mask branch forward and backward, the losses
    forward and backward, and Adam."""
    model, cfg = trainer.model, trainer.cfg
    batch = draw()
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps), use_contract=cfg.contract,
        min_near=cfg.min_near, background=cfg.background, bound=cfg.bound,
        training=True, return_mask=True, frozen_backbone=False)
    mlp_calls, lookups = [], []

    def spy_mlp(x, *a, **k):
        mlp_calls.append((x.detach(), a, k))
        return fused_freq_mlp(x, *a, **k)

    def spy_lookup(*a):
        lookups.append(a)
        return sample_pdf_lookup(*a)

    mlp_field.fused_freq_mlp, ray_ops.sample_pdf_lookup = spy_mlp, spy_lookup
    try:
        out, calls = capture_render(model, settings, batch,
                                    ("forward_color", "mask_features"))
    finally:
        mlp_field.fused_freq_mlp = fused_freq_mlp
        ray_ops.sample_pdf_lookup = sample_pdf_lookup
    assert len(mlp_calls) == 2 and len(lookups) == 2, (len(mlp_calls),
                                                       len(lookups))
    parts = {"sampler": cuda_ms(draw)}
    with torch.no_grad():
        parts["K8, both proposal levels (narrow design)"] = cuda_ms(
            lambda: [fused_freq_mlp(x, *a, **k) for x, a, k in mlp_calls])
        parts["K8, both proposal levels (device time, CUDA graph)"] = \
            graph_ms(lambda: [fused_freq_mlp(x, *a, **k)
                              for x, a, k in mlp_calls])
        parts["K10, both levels (device time, CUDA graph)"] = graph_ms(
            lambda: [sample_pdf_lookup(*a) for a in lookups])
    (xyz, dirs), _, fc = calls["forward_color"][0]
    xyz, dirs = xyz.detach(), dirs.detach()
    parts["plain CP trunk forward (forward_color)"] = cuda_ms(
        lambda: model.forward_color(xyz, dirs))
    N, T = xyz.shape[:2]
    g = torch.Generator(xyz.device).manual_seed(8)
    bins = torch.sort(torch.rand(N, T + 1, generator=g, device=xyz.device),
                      -1).values
    sigma, geo, colors = fc[0].detach(), fc[1].detach(), fc[2].detach()

    def composite():
        w, _ = compute_weights(bins[:, 1:] - bins[:, :-1], sigma)
        f = (w[..., None] * colors).sum(-2)
        return torch.sigmoid(model.apply_view_mlp(f)), w

    parts["compositing and view MLP forward"] = cuda_ms(composite)
    w = composite()[1].detach()
    trainable = [p for n_, p in model.named_parameters()
                 if n_.startswith(("cp_m_", "mask_mlp"))]
    xm = calls["mask_features"][0][0][0].detach()

    def branch():
        m_in = torch.cat([model.mask_features(xm), geo], dim=-1)
        logits = (w[..., None] * model.apply_mask_mlp(m_in)).sum(dim=-2)
        torch.autograd.grad(logits.square().sum(), trainable)

    parts["mask branch fwd+bwd"] = cuda_ms(branch)
    logits = out["instance_mask_logits"].detach().requires_grad_()
    loss_in = dict(out, instance_mask_logits=logits)

    def losses():
        loss, _, _ = mask_losses(loss_in, batch, MASK_STEPS, em, cfg, gen)
        torch.autograd.grad(loss, logits)

    parts["losses fwd+bwd"] = cuda_ms(losses)
    step = make_mask_train_step(model, cfg, frozen_backbone=False)
    step.loss_fn(batch, trainer.state.step, em, gen)[0].backward()
    # repeated updates move the weights: timing only, after the step rate
    parts["Adam (the mask branch has grads)"] = cuda_ms(
        trainer.state.optimizer.step)
    trainer.state.optimizer.zero_grad(set_to_none=True)
    return parts


# the hash-grid stage-3 step's device kernels by kind: the encodes'
# index_select gathers (forward, the backbone's three and m_grid), their
# index_add_ (m_grid's backward), the elementwise kernels (the encodes'
# index and weight arithmetic, most of the rest), K10, the products, Adam
SCRIPTS_GROUPS = (("K10", ("sample_pdf_lookup",)),
                  ("gathers (index_select)", ("gather_kernel",)),
                  ("scatter-add (index_add_)", ("indexfunc",)),
                  ("matrix products", ("gemm", "cutlass")),
                  ("Adam", ("multi_tensor",)),
                  ("elementwise", ("elementwise",)))
SCRIPTS_DS = 4  # scripts/train_rgb_nerf.sh --downscale 4: images_4/ at VIEW
SCRIPTS_S1_STEPS = 20  # stage-1 --iters, cut from the script's 5000
VARIANT_STEPS = 20  # stage-3 steps: lightweight, packed and feat_rep runs
MASK_CPU_RAYS = 1024  # the stage-3 card-vs-CPU batch


def run_cli(argv):
    """One CLI run with the launch counts set to 0 just before and read
    just after: (trainer, seconds, launches)."""
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0, read_counts()


def latest_model(ws):
    return torch.load(CheckpointManager(ws).latest_path(), map_location="cpu",
                      weights_only=True)["model"]


def rebuild_chunks(cfg, n_train=15):
    """Render chunks of the error-map rebuilds in a CLI run of cfg.iters
    stage-3 steps: every ray_pair_rgb_iter steps, one view of
    error_map_size^2 rays a training view."""
    n = sum(1 for s_ in range(1, cfg.iters + 1)
            if cfg.ray_pair_rgb_iter > 0 and s_ % cfg.ray_pair_rgb_iter == 0)
    return n * n_train * -(-cfg.error_map_size ** 2 // CHUNK)


def mask_branch_moved(trainer, init):
    """Names of the parameters that stage 3 moved from the seeded weights
    the EMA (never updated in stage 3) still holds: none of `init`'s (the
    stage-1 tensors), each of the mask branch."""
    ema = dict(trainer.state.ema_model.named_parameters())
    moved = sorted(n_ for n_, p in trainer.model.named_parameters()
                   if not torch.equal(p, ema[n_]))
    assert moved and all(n_ not in init for n_ in moved), moved
    return moved


def scripts_path(work):
    """Phase 11: the three scripts without SAM on a COLMAP scene, through
    the CLI with the flags read out of scripts/*.sh, then the stage-3
    step's rate and parts, the lightweight, packed and feat_rep variants
    and the card against the CPU."""
    root = os.path.join(work, "scripts")
    env = {"SANERFHQ_DATA_PATH": os.path.join(root, "scene"),
           "SANERFHQ_WORKSPACE_ROOT": os.path.join(root, "ws"),
           "SANERFHQ_SCENE": "sphere",
           "SANERFHQ_MASK_PATH": os.path.join(root, "masks"),
           "SANERFHQ_INIT_CKPT": os.path.join(root, "ws", "rgb_nerf",
                                              "sphere")}
    scene, masks_dir = env["SANERFHQ_DATA_PATH"], env["SANERFHQ_MASK_PATH"]
    n_views, full = 17, VIEW * SCRIPTS_DS
    t0 = time.perf_counter()
    write_colmap_scene(scene, n_views=n_views, H=VIEW, W=VIEW,
                       downscale=SCRIPTS_DS)
    write_sphere_masks(masks_dir, n_views=n_views, H=full, W=full)
    # the scripts' relative --test_view_path, written here and passed by
    # its absolute path
    test_views = os.path.join(root, "example_test_views.json")
    with open(test_views, "w") as f:
        json.dump(["v00", "v16"], f)
    print(f"[scripts] COLMAP scene (Mip-NeRF 360 layout: images/ {full}x"
          f"{full}, images_{SCRIPTS_DS}/ {VIEW}x{VIEW}, sparse/0 binary "
          f"model, {n_views} views, held out v00 and v16) and sphere masks "
          f"at {full}x{full} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    out = {"launches": {}}

    # 1. stage 1: scripts/train_rgb_nerf.sh
    argv1 = script_argv("train_rgb_nerf.sh", env)
    trainer1, dt, launches = run_cli(argv1 + ["--iters",
                                              str(SCRIPTS_S1_STEPS)])
    model, cfg, n = trainer1.model, trainer1.cfg, trainer1.state.step
    assert isinstance(model, SANeRFField) and not model.packed
    assert not model.with_mask and n == SCRIPTS_S1_STEPS
    assert (cfg.data_type, cfg.downscale, cfg.enable_cam_center,
            cfg.random_image_batch, cfg.contract) == ("mip", SCRIPTS_DS,
                                                      True, True, True)
    assert cfg.num_rays == BATCH
    per_view = -(-VIEW * VIEW // CHUNK)
    eval_k10 = launches["K10"] - 2 * n
    views = eval_k10 // (2 * per_view)
    assert views > 0 and eval_k10 == 2 * per_view * views, launches
    for k in LEVEL_KERNELS + ("K8",):
        assert launches[k] == 0, launches
    losses = trainer1.stats["loss"]
    assert losses and all(np.isfinite(losses)), losses
    ws1 = env["SANERFHQ_INIT_CKPT"]
    ckpts = sorted(os.listdir(os.path.join(ws1, "checkpoints")))
    assert f"step_{n:08d}.pt" in ckpts, ckpts
    s1 = load_scene(scene, "mip", SCRIPTS_DS, enable_cam_center=True,
                    load_images=False)
    nf = s1.cam_near_far
    assert nf.shape == (n_views, 2) and np.isfinite(nf).all()
    assert (0 < nf[:, 0]).all() and (nf[:, 0] < nf[:, 1]).all()
    print(f"[scripts] 1. scripts/train_rgb_nerf.sh {' '.join(argv1[1:])} "
          f"--iters {SCRIPTS_S1_STEPS} (cut from 5000): {n} steps of "
          f"{cfg.num_rays} rays, {views} eval views of {VIEW}x{VIEW} in "
          f"{dt:.2f} s; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items())
          + f"; losses by epoch {losses}; checkpoints {ckpts}; per-view "
          f"near {nf[:, 0].min():.4f}..{nf[:, 0].max():.4f}, far "
          f"{nf[:, 1].min():.4f}..{nf[:, 1].max():.4f} (sparse points, "
          f"scale {s1.scale:.5f})", flush=True)
    out["launches"]["stage1"] = launches
    out.update(stage1_steps=n, stage1_losses=losses,
               near_range=[float(nf[:, 0].min()), float(nf[:, 0].max())],
               far_range=[float(nf[:, 1].min()), float(nf[:, 1].max())])

    # 2. stage 3: scripts/train_obj_nerf.sh over step 1's workspace
    argv2 = script_argv("train_obj_nerf.sh", env)
    argv2[argv2.index("--test_view_path") + 1] = test_views
    torch.cuda.reset_peak_memory_stats()
    trainer3, dt, launches = run_cli(argv2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model, cfg = trainer3.model, trainer3.cfg
    assert isinstance(model, SANeRFField) and model.with_mask
    assert model.mask_mlp_type == "default" and not model.m_spec.packed
    assert model.m_grid.shape == (5_258_512, 8)
    assert trainer3.backbone_frozen and trainer3.state.step == MASK_STEPS
    n_train = n_views - 2
    n_rays = (cfg.num_rays
              + cfg.num_local_sample * cfg.local_sample_patch_size ** 2)
    rebuilds = [s_ for s_ in range(1, MASK_STEPS + 1)
                if s_ % cfg.ray_pair_rgb_iter == 0]
    em_chunks = len(rebuilds) * n_train * -(-cfg.error_map_size ** 2
                                             // CHUNK)
    val_chunks = 2 * -(-full * full // CHUNK)
    assert launches["K10"] == 2 * (MASK_STEPS + em_chunks + val_chunks), (
        launches, em_chunks, val_chunks)
    for k in LEVEL_KERNELS + ("K8",):
        assert launches[k] == 0, launches
    init = latest_model(ws1)
    for name, p in init.items():
        assert torch.equal(model.state_dict()[name].cpu(), p), name
    moved = mask_branch_moved(trainer3, init)
    assert set(moved) == {"m_grid", "mask_mlp.layers.0.weight",
                          "mask_mlp.layers.1.weight",
                          "mask_mlp.layers.2.weight"}, moved
    ws3 = cfg.workspace
    with open(os.path.join(ws3, "log_ngp.txt")) as f:
        log = f.read()
    for s_ in rebuilds:
        assert f"[INFO] error map rebuilt at step {s_}\n" in log, log[-2000:]
    miou = float(log.split("[EVAL] MeanIoU = ")[-1].split()[0])
    hist = trainer3.stats["mask"]
    assert all(np.isfinite(v["loss"]) for _, v in hist), hist
    (s_first, m_first), (s_last, m_last) = hist[0], hist[-1]
    print(f"[scripts] 2. scripts/train_obj_nerf.sh (the hash-grid object "
          f"field, m_grid {tuple(model.m_grid.shape)}): {MASK_STEPS} steps "
          f"of {n_rays} rays, error-map rebuilds at {rebuilds}, mIoU eval "
          f"({val_chunks} chunks of {full}x{full}) in {dt:.2f} s; peak "
          f"device memory {peak:.3f} GiB; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items())
          + f"; backbone: all {len(init)} tensors bitwise equal to step 1's "
          f"checkpoint, moved: {moved}; CE step {s_first} "
          f"{m_first['ce']:.5f}, step {s_last} {m_last['ce']:.5f} (loss "
          f"{m_last['loss']:.5f}, ray_pair {m_last['ray_pair']:.5f}, acc "
          f"{m_last['acc']:.4f}); [EVAL] MeanIoU {miou:.6f}", flush=True)
    out["launches"]["stage3"] = launches
    out.update(stage3_seconds=dt, peak_memory_gib=peak, miou=miou,
               ce_first=m_first["ce"], ce_last=m_last["ce"],
               rays_per_step=n_rays)

    # the step rate: host clock around synchronised steps, on batches
    # drawn as train_mask draws them
    dev = trainer3.device
    res = cfg.online_resolution
    s_full = load_scene(scene, "mip", 1, enable_cam_center=True,
                        load_images=False)
    idx = split_indices(n_views, "train", "val_split", ["v00", "v16"],
                        s_full.img_names)
    masks_t = torch.as_tensor(np.stack([resize_nearest(np.load(
        os.path.join(masks_dir, f"v{i:02d}_obj_mask.npy"))[0], res, res)
        for i in idx]), dtype=torch.long, device=dev)
    poses_t = torch.as_tensor(s_full.poses[idx], device=dev)
    intr_t = torch.as_tensor(fixed_fovy_intrinsics(res, 60.0), device=dev)
    S = cfg.error_map_size
    gen = torch.Generator(dev).manual_seed(11)
    em = torch.rand((len(idx), S * S), device=dev) + 0.05

    def draw():
        return sample_mask_batch(gen, masks_t, poses_t, intr_t, em,
                                 cfg.num_rays, cfg.num_local_sample,
                                 cfg.local_sample_patch_size, res, res, S)

    mask_step = make_mask_train_step(model, cfg, frozen_backbone=True)

    def step():
        return mask_step(trainer3.state, draw(), gen, em)[0]

    sps = steps_per_s(step)
    print(f"[scripts] stage 3: {sps:.3f} steps/s at {n_rays} rays a step "
          f"({1e3 / sps:.2f} ms a step, mean of 20 after 3 warm-up) on "
          f"{device_line()}", flush=True)
    parts = hashgrid_mask_step_parts(trainer3, draw, gen, em)
    print("[scripts] stage 3, parts of a step, each timed alone (CUDA "
          "events, ms; alone each also waits on its own launches): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; whole step {1e3 / sps:.4f} ({device_line()})", flush=True)
    out.update(steps_per_s=sps, parts_alone_ms=parts,
               trace=(step, SCRIPTS_GROUPS))

    # 3. stage-3 --test: scripts/test_obj_nerf.sh
    argv3 = script_argv("test_obj_nerf.sh", env)
    argv3[argv3.index("--test_view_path") + 1] = test_views
    tested, dt, launches = run_cli(argv3)
    assert tested.resumed and tested.state.step == MASK_STEPS
    assert isinstance(tested.model, SANeRFField) and tested.model.with_mask
    assert launches["K10"] == 2 * val_chunks, launches
    for k in LEVEL_KERNELS + ("K8",):
        assert launches[k] == 0, launches
    for stem in ("v00", "v16"):
        probs = np.load(os.path.join(ws3, "results", f"{stem}_mask.npy"))
        assert probs.shape == (full, full, 2) and np.isfinite(probs).all()
        vis = read_png(os.path.join(ws3, "results", f"{stem}_mask_vis.png"))
        assert vis.shape == (full, full, 3)
    print(f"[scripts] 3. scripts/test_obj_nerf.sh: resumed at step "
          f"{tested.state.step}, {val_chunks} chunks in {dt:.2f} s, "
          f"launches K10 {launches['K10']}; results/v00_mask.npy "
          f"({full}x{full}x2), v16_mask_vis.png written", flush=True)
    out["launches"]["test"] = launches
    out["test_seconds"] = dt
    del tested

    # 4, 5. twenty stage-3 steps of the lightweight mask MLP and of the
    # packed field (over a 5-step packed stage 1), their evals at
    # --downscale SCRIPTS_DS
    small_val = 2 * per_view
    cut = ["--iters", str(VARIANT_STEPS), "--downscale", str(SCRIPTS_DS)]
    ws_root = env["SANERFHQ_WORKSPACE_ROOT"]
    ws_p1 = os.path.join(ws_root, "rgb_packed")
    t_p1, dt_p1, l_p1 = run_cli(argv1 + [
        "--field_type", "hashgrid_packed", "--iters", str(PACKED_STEPS),
        "--workspace", ws_p1])
    assert t_p1.model.packed and t_p1.state.step == PACKED_STEPS
    assert all(np.isfinite(t_p1.stats["loss"]))
    del t_p1
    variants = {}
    for tag, extra, init_ws in (
            ("lightweight", ["--mask_mlp_type", "lightweight_mask"], ws1),
            ("packed", ["--field_type", "hashgrid_packed", "--init_ckpt",
                        ws_p1], ws_p1)):
        ws_v = os.path.join(ws_root, f"obj_{tag}")
        tv, dt, launches = run_cli(argv2 + cut + extra + ["--workspace",
                                                         ws_v])
        m = tv.model
        if tag == "lightweight":
            assert m.m_spec == lightweight_mask_grid_spec()
            assert m.m_grid.shape == (16 * 1024, 2) and not m.m_spec.packed
            assert m.mask_mlp.layers[0].weight.shape == (64, 32 + 31)
        else:
            assert m.packed and m.m_spec.packed
            assert m.m_grid.shape == (5_258_512, 64)
        assert tv.backbone_frozen and tv.state.step == VARIANT_STEPS
        assert launches["K10"] == 2 * (VARIANT_STEPS + small_val
                                       + rebuild_chunks(tv.cfg)), launches
        for k in LEVEL_KERNELS + ("K8",):
            assert launches[k] == 0, launches
        init_v = latest_model(init_ws)
        for name, p in init_v.items():
            assert torch.equal(m.state_dict()[name].cpu(), p), (tag, name)
        moved_v = mask_branch_moved(tv, init_v)
        h = tv.stats["mask"]
        assert all(np.isfinite(v["loss"]) for _, v in h), h
        mb = m.m_grid.numel() * 4 / 2 ** 20
        print(f"[scripts] {4 if tag == 'lightweight' else 5}. {tag}: "
              f"{VARIANT_STEPS} stage-3 steps and the eval at "
              f"{VIEW}x{VIEW} in {dt:.2f} s, m_grid "
              f"{tuple(m.m_grid.shape)} ({mb:.1f} MiB); launches " + ", ".join(
                  f"{k} {v}" for k, v in launches.items())
              + f"; backbone bitwise kept, {len(moved_v)} mask tensors "
              f"moved; CE step {h[0][0]} {h[0][1]['ce']:.5f}, step "
              f"{h[-1][0]} {h[-1][1]['ce']:.5f}", flush=True)
        out["launches"][tag] = launches
        variants[tag] = {"seconds": dt, "ce_first": h[0][1]["ce"],
                         "ce_last": h[-1][1]["ce"],
                         "m_grid_shape": list(m.m_grid.shape)}
        del tv
    variants["packed"]["stage1_seconds"] = dt_p1

    # 6. the MLP field's m_grid (--feat_rep hashgrid) over the phase-5
    # field, on the phase-4 scene with the phase-7 masks: K5 and K6 render
    # the frozen backbone
    env6 = dict(env, SANERFHQ_DATA_PATH=os.path.join(work, "scene"),
                SANERFHQ_MASK_PATH=os.path.join(work, "masks"),
                SANERFHQ_INIT_CKPT=os.path.join(work, "train_ws"))
    argv6 = script_argv("train_obj_nerf.sh", env6)
    argv6[argv6.index("--test_view_path") + 1] = test_views
    ws6 = os.path.join(ws_root, "obj_featrep")
    t6, dt, launches = run_cli(argv6 + [
        "--data_type", "llff", "--field_type", "mlp", "--feat_rep",
        "hashgrid", "--iters", str(VARIANT_STEPS), "--workspace", ws6])
    m = t6.model
    assert m.feat_rep == "hashgrid" and m.m_grid.shape == (5_258_512, 8)
    assert t6.backbone_frozen and t6.state.step == VARIANT_STEPS
    assert launches["K6"] == (VARIANT_STEPS + small_val
                              + rebuild_chunks(t6.cfg)), launches
    assert launches["K5"] == 2 * launches["K6"], launches
    for k in ("K1", "K2", "K3", "K4", "K7", "K8", "K10"):
        assert launches[k] == 0, launches
    init6 = latest_model(env6["SANERFHQ_INIT_CKPT"])
    for name, p in init6.items():
        assert torch.equal(m.state_dict()[name].cpu(), p), name
    moved6 = mask_branch_moved(t6, init6)
    h = t6.stats["mask"]
    assert all(np.isfinite(v["loss"]) for _, v in h), h
    print(f"[scripts] 6. --field_type mlp --feat_rep hashgrid --with_mask "
          f"--init_ckpt <phase-5 workspace>: {VARIANT_STEPS} steps and the "
          f"eval in {dt:.2f} s; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items())
          + f"; backbone bitwise kept, moved {moved6}; CE step {h[0][0]} "
          f"{h[0][1]['ce']:.5f}, step {h[-1][0]} {h[-1][1]['ce']:.5f}",
          flush=True)
    out["launches"]["feat_rep"] = launches
    variants["feat_rep"] = {"seconds": dt, "ce_first": h[0][1]["ce"],
                            "ce_last": h[-1][1]["ce"]}
    out["variants"] = variants
    del t6

    # 7. the card against the CPU on one batch of global rays
    out["card_vs_cpu"] = mask_card_vs_cpu(trainer3, draw())
    return out


def hashgrid_mask_step_parts(trainer, draw, gen, em):
    """CUDA-event times of a hash-grid stage-3 step's parts, each alone on
    one batch's own inputs: the sampler, the backbone's forward (three
    hash encodes and MLPs, no grad: it is frozen), K10 at both levels, the
    m_grid encode forward and backward, the mask MLP forward and backward,
    the losses forward and backward with TV / WD off and with --lambda_tv
    1e-4 (TV on m_grid), and Adam over the mask branch."""
    model, cfg = trainer.model, trainer.cfg
    batch = draw()
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps), use_contract=cfg.contract,
        min_near=cfg.min_near, background=cfg.background, bound=cfg.bound,
        training=True, return_mask=True, frozen_backbone=True)
    lookups = []

    def spy_lookup(*a):
        lookups.append(a)
        return sample_pdf_lookup(*a)

    ray_ops.sample_pdf_lookup = spy_lookup
    try:
        out, calls = capture_render(model, settings, batch, (
            "density", "forward_color", "mask_features"))
    finally:
        ray_ops.sample_pdf_lookup = sample_pdf_lookup
    assert len(lookups) == 2 and len(calls["density"]) == 2
    parts = {"sampler": cuda_ms(draw)}
    x0, x1 = (c[0][0].detach() for c in calls["density"])
    (x2, d2), _, fc = calls["forward_color"][0]
    with torch.no_grad():
        parts["backbone forward (3 hash encodes, MLPs)"] = cuda_ms(
            lambda: (model.density(x0, proposal=0),
                     model.density(x1, proposal=1),
                     model.forward_color(x2, d2)))
    parts["K10, both levels (device time, CUDA graph)"] = graph_ms(
        lambda: [sample_pdf_lookup(*a) for a in lookups])
    xm = calls["mask_features"][0][0][0].detach()

    def encode():
        f = hash_encode(model.m_grid, xm, model.m_spec,
                        bound=model.grid_bound)
        torch.autograd.grad(f.square().sum(), model.m_grid)

    parts[f"m_grid encode fwd+bwd ({xm.shape[0]}x{xm.shape[1]} points)"] = \
        cuda_ms(encode)
    with torch.no_grad():
        feats = model.mask_features(xm)
    feats.requires_grad_()
    geo, w = fc[1].detach(), out["weights"].detach()
    mlp_params = list(model.mask_mlp.parameters())

    def mask_mlp():
        m_in = torch.cat([feats, geo], dim=-1)
        logits = (w[..., None] * model.apply_mask_mlp(m_in)).sum(dim=-2)
        torch.autograd.grad(logits.square().sum(), mlp_params + [feats])

    parts["mask MLP fwd+bwd"] = cuda_ms(mask_mlp)
    logits = out["instance_mask_logits"].detach().requires_grad_()
    loss_in = dict(out, instance_mask_logits=logits)
    reg = _grid_regularizers(model, cfg.replace(lambda_tv=1e-4), "mask")

    def losses(tv=False):
        loss, _, _ = mask_losses(loss_in, batch, MASK_STEPS, em, cfg, gen)
        if tv:
            loss = loss + reg(gen)
            torch.autograd.grad(loss, [logits, model.m_grid])
        else:
            torch.autograd.grad(loss, logits)

    parts["losses fwd+bwd, TV / WD off"] = cuda_ms(losses)
    parts["losses fwd+bwd, --lambda_tv 1e-4"] = cuda_ms(
        lambda: losses(tv=True))
    step = make_mask_train_step(model, cfg, frozen_backbone=True)
    step.loss_fn(batch, trainer.state.step, em, gen)[0].backward()
    # repeated updates move the weights: timing only, after the step rate
    parts["Adam (m_grid and mask_mlp)"] = cuda_ms(
        trainer.state.optimizer.step)
    trainer.state.optimizer.zero_grad(set_to_none=True)
    return parts


def mask_card_vs_cpu(trainer, batch):
    """Phase 11: the hash-grid object field's loss, logits and m_grid /
    mask_mlp grads on MASK_CPU_RAYS global rays of a stage-3 batch, on the
    card and on the CPU with the same weights; the CPU's render is handed
    the card's resampled bins (K10's outputs), as phase 8's check does.
    Bars: loss and logits max abs <= 1e-3, grads rel-max <= 1e-3."""
    model, dev = trainer.model, trainer.device
    n = MASK_CPU_RAYS
    cfg = trainer.cfg.replace(num_rays=n, num_local_sample=0)
    cpu = SANeRFField(with_mask=True, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    settings = RenderSettings(
        num_steps=tuple(cfg.num_steps), use_contract=cfg.contract,
        min_near=cfg.min_near, background=cfg.background, bound=cfg.bound,
        training=True, return_mask=True, frozen_backbone=True)
    b = {k: batch[k][:n] for k in ("rays_o", "rays_d", "gt_masks",
                                   "img_inds", "inds_coarse")}
    S = cfg.error_map_size
    em = torch.rand((int(b["img_inds"].max()) + 1, S * S),
                    generator=torch.Generator().manual_seed(12))
    names = ["m_grid"] + [f"mask_mlp.layers.{i}.weight" for i in range(3)]

    def run(m, d, lookup):
        ray_ops.sample_pdf_lookup = lookup
        try:
            bd = {k: v.to(d) for k, v in b.items()}
            out = render_rays(m, bd["rays_o"], bd["rays_d"], settings)
        finally:
            ray_ops.sample_pdf_lookup = sample_pdf_lookup
        loss, _, _ = mask_losses(out, bd, MASK_STEPS, em.to(d), cfg)
        params = dict(m.named_parameters())
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return (loss.item(), out["instance_mask_logits"].detach().cpu(),
                [g_.cpu() for g_ in grads])

    recorded = []

    def record(*a):
        o = sample_pdf_lookup(*a)
        recorded.append((a, o))
        return o

    cdf_err = []

    def replay(cdf, bins, u):
        (c, _, _), o = recorded[len(cdf_err)]
        cdf_err.append((cdf - c.cpu()).abs().max().item())
        return o.cpu()

    card = run(model, dev, record)
    lookup_equal = all(torch.equal(sample_pdf_lookup_ref(*(x.cpu() for x in
                                                           a)), o.cpu())
                       for a, o in recorded)
    handed = run(cpu, "cpu", replay)
    loss_err = abs(card[0] - handed[0])
    logit_err = (card[1] - handed[1]).abs().max().item()
    g_rel = {k: rel_max(a, b_) for k, a, b_ in zip(names, card[2],
                                                   handed[2])}
    print(f"[scripts] 7. card vs CPU, {n} global rays of a stage-3 batch: "
          f"K10's outputs bitwise equal to the CPU's plain lookup "
          f"{lookup_equal}, the two cdfs max abs {max(cdf_err):.2e}; CPU "
          f"handed the card's bins: loss {card[0]:.6f} vs {handed[0]:.6f} "
          f"(diff {loss_err:.2e} <= 1e-3), instance_mask_logits max abs "
          f"{logit_err:.2e} (<= 1e-3); grads rel-max " + ", ".join(
              f"{k} {v:.2e}" for k, v in g_rel.items()) + " (<= 1e-3)",
          flush=True)
    assert lookup_equal or all(
        (sample_pdf_lookup_ref(*(x.cpu() for x in a)) - o.cpu()).abs().max()
        <= 1e-6 for a, o in recorded)
    assert loss_err <= 1e-3 and logit_err <= 1e-3, (loss_err, logit_err)
    assert max(g_rel.values()) <= 1e-3, g_rel
    return {"lookup_bitwise_equal": lookup_equal, "cdf_max_abs":
            max(cdf_err), "loss_diff": loss_err, "logits_max_abs": logit_err,
            "grad_rel_max": g_rel}


def main(argv):
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    ab = argv == ["--ab"]
    if argv and not ab:
        print(f"error: unknown arguments {argv} (none, or --ab)",
              file=sys.stderr)
        return 2
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
    trunk0 = make_field("mlp", device="cuda", seed=0, cp_rank=0).trunk
    if ab:
        with torch.inference_mode():
            digests = level_digests(field)
        k8 = check_mlp_kernel(field, trunk0)
        print(json.dumps({"digests": digests, "K8": k8}))
        print(dev_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    with torch.inference_mode():
        digests = level_digests(field)
        kernels = check_kernels(field)
        kernels.update(check_train_kernels(field))
        kernels["K10"] = check_sample_pdf_kernel(torch.device("cuda"))
    kernels["K3"]["train_shape_ms"] = kernels.pop("K3_train_ms")
    kernels["K7"] = check_prop_weights_kernel(field)
    kernels["K8"] = check_mlp_kernel(field, trunk0)
    launches, mrays = main_path(work)
    trainer, train_launches, sps, train_step = train_path(work)
    parity = grad_parity(trainer, os.path.join(work, "scene"))
    s3_launches, s3 = stage3_path(work, os.path.join(work, "train_ws"))
    hg_trainer, hg_launches, hg = hashgrid_train_path(work)
    hg["card_vs_cpu"] = card_vs_cpu(hg_trainer, os.path.join(work, "scene"))
    hg["packed"] = packed_path(work)
    tr_launches, trainable = stage3_trainable_path(work)
    scripts = scripts_path(work)
    # the device-time breakdowns of phases 5, 7, 8 and 9, traced after
    # every rate: a torch.profiler trace slows the host's later steps
    print("[train] the stage-1 step's device time by kernel (phase 5's "
          "trainer):", flush=True)
    train_profile = profile_steps(train_step, STAGE1_GROUPS)
    k4_gemms = {name: {"ms": train_profile[name], "bound_ms": b, "bound_by": by}
                for name, (b, by) in kernels["K4"].pop("gemm_bounds").items()}
    print("[train] K4's GEMMs, device ms a stage-1 step (the trace) beside "
          "their bounds (phase 3's inputs): " + ", ".join(
              f"{k} {v['ms']:.4f} (bound {v['bound_ms']:.4f}, "
              f"{v['bound_by']})" for k, v in k4_gemms.items()), flush=True)
    k3_trace = {name: train_profile[name] for name, _ in K3_PARTS}
    print("[train] K3's parts, device ms a stage-1 step (the trace): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k3_trace.items())
          + f"; K3 {sum(k3_trace.values()):.4f}, K1 {train_profile['K1']:.4f}",
          flush=True)
    for tag, res in (("stage3", s3), ("hashgrid", hg),
                     ("trainable", trainable),
                     ("trainable cp_rank 0", trainable["cp0"]),
                     ("scripts stage 3", scripts)):
        step, groups = res.pop("trace")
        print(f"[{tag}] the step's device time by kernel:", flush=True)
        res["profile"] = profile_steps(step, groups)

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
    # the parts of K2 and K4, with their launches on the training path
    counter = {fn.__name__: key for key, fn in COUNTERS.items()}
    for row in report:
        for name, part in row.get("parts", {}).items():
            # each launch of K3 runs each of its parts once
            part["launches"] = (row["launches"] if row["name"] ==
                                "fused_final_level"
                                else train_launches[counter[name]])
    # K10: the hash-grid field's stage-1 run (phase 8) and its stage-3 run
    # through scripts/train_obj_nerf.sh (phase 11)
    report.append({"name": "sample_pdf_lookup", "route": "cuda",
                   "source": SOURCE_PDF, "replaces": f"{TPU_FILE_PDF}:69",
                   "launches": hg_launches["K10"]
                   + scripts["launches"]["stage3"]["K10"],
                   "library_ms": None, **kernels["K10"]})
    # K7: no route of the renderer calls it (as in JAX), so its count on
    # the phase-9 path is 0; K8's launches are phase 9's (2 a step), its
    # headline numbers the sums over both proposal shapes, the trunk's in
    # per_shape; K9 is the same CUDA code as K8
    report.append({"name": "fused_prop_level", "route": "cuda",
                   "source": SOURCE, "replaces": f"{TPU_FILE}:220",
                   "launches": tr_launches["K7"], "library_ms": None,
                   **kernels["K7"]})
    report.append({"name": "fused_freq_mlp", "route": "cuda",
                   "source": SOURCE_MLP, "replaces": f"{TPU_FILE_MLP}:251",
                   "launches": tr_launches["K8"], "library_ms": None,
                   **kernels["K8"]})
    report.append({"name": "fused_freq_mlp (K9, row-major: K8's kernels)",
                   "route": "cuda", "source": SOURCE_MLP,
                   "replaces": f"{TPU_FILE_MLP}:145",
                   "launches": tr_launches["K8"], "library_ms": None,
                   **{k: v for k, v in kernels["K8"].items()
                      if k != "per_shape"}})
    print(json.dumps({"kernels": report, "level_digests": digests,
                      "render_mrays_per_s": mrays,
                      "train_steps_per_s": sps,
                      "train_launches": train_launches,
                      "train_profile_ms_a_step": train_profile,
                      "k4_gemms": k4_gemms, "k3_trace": k3_trace,
                      "grad_parity_worst_rel_l2": max(parity.values()),
                      "stage3_launches": s3_launches, "stage3": s3,
                      "hashgrid": hg, "stage3_trainable_launches":
                      tr_launches, "stage3_trainable": trainable,
                      "scripts_path": scripts}))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
