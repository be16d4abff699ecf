#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`sanerf_hq_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py           # every phase
    python3 chip_smoke.py --ab      # phases 1 and 2, the level kernels'
                                    # output digests and K8's check alone

    python3 chip_smoke.py --dp-cards  # phase 15 (a) and (b) on every
                                      # card of the host: world size N
                                      # against 1
    python3 chip_smoke.py --rich-all  # phase 16's chain three more ways
                                      # (DISTILL_ITERS=5000, FIELD=hashgrid,
                                      # KIND=clutter) and its stage 1 on
                                      # the composable route
    python3 chip_smoke.py --k11     # phases 1 and 2 and K11's check alone

(`--dp-worker <spec>` is phase 15's process under torch.distributed.run.)

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
       K3's, and K6 with need_geo=False (the distill container's form, no
       trunk features) the same against its twin and K3; K5 and K6 also timed at a 6256-ray stage-3 batch; K3's parts
       on the chunk, each beside its plain part and its bound: the trunk's
       input (h_in rel-max < 2e-2), the four layer products (rel-max < 2e-2,
       the fp32 last layer < 1e-4; torch's bf16 matmul of the same
       operands timed beside each) and the compositing (rel-max < 2e-2),
       and the peak device memory a chunk's K3 call adds;
     - training, one 8192-ray batch with random cotangents: K1 at both
       proposal levels (bins max abs <= 1e-3 and equal to K5's, weights
       rel-max < 2e-2), K2 at T = 128 and 64 and K4 at T = 32 (rel-max
       < 2e-2 on every weight and CP grad; the weight grads bitwise equal
       over two launches, and K4's CP grads, summed in a fixed order,
       too); K7 at both proposal levels (weights rel-max
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
     - K11 (the hash-grid encoder) at each encode of a stage-1 step (8192
       rays; proposal grids at 128 and 64 samples, the main grid at 32)
       and of a stage-3 step (6256 rays; m_grid at 32): forward and
       backward on the device alone, a forward call from the host, the
       twin's times, the bound in bytes, the output against the twin
       (max abs <= 1e-9) and the table grads (rel-max <= 1e-5) beside the
       twin's own run-to-run spread (`--k11` runs this check alone);
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
     twice a step and twice an eval chunk, K11 six times a step (three
     encodes forward and backward) and three times an eval chunk, K1-K8
     never; a finite loss,
     checkpoints, the step rate with its breakdown (CUDA events: the
     sampler, the three hash encodes forward and backward, K10, the MLPs,
     compositing and losses, Adam; one device-only torch.profiler trace,
     taken in 10); a --test resuming it (K10 twice and K11 three times a
     chunk) and the render rate; the
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
 12. SAM, stage 2 and the decode (run after 11, before 10's traces): a
     point file with, for each view, the sparse point nearest its camera
     (on the sphere's front surface; write_sphere_points); the flags of
     scripts/train_sam_nerf.sh and decode.sh read out of the scripts, over
     phase 11's stage-1 workspace and scene, with --downscale 4 appended
     (512x512 views; the scripts' 2048x2048 would render each view for
     about 30 s), the decode's relative --point_file replaced by the file
     written here; SAM vit_h at 1024^2 with random weights from --seed;
     counts set to 0 just before and read just after each CLI run:
     1. stage 2 (--with_sam --feature_container cache): K10 twice a chunk
        of every view, K1-K9 never; the backbone frozen and only the SAM
        branch (built with --with_sam) trainable; sam_cache/ with one [64, 64, 256]
        float32 file a view; the seconds a view, the peak device memory;
     2. the decode (--test --decode --use_point): K10 the same;
        {stem}_obj_mask.npy [1, 512, 512] uint8 and {stem}_rgb.png a view,
        valid_dict.json over every view, at least one view valid at the
        CLI's depth_tol 0.05 (each view's depth-gate line printed);
     3. vit_h's times (CUDA events, median of 10 after 2 warm-up calls):
        set_image on a 512x512 view, the encoder alone, predict with 1 and
        5 points for sam and sam_hq (sam_hq's features from set_image),
        the memory set_image adds over the weights;
     4. the card against the CPU at vit_b with the same weights: the
        encoder on one 1024^2 image (features and the four global blocks'
        outputs) and the low-res logits and IoU of a 5-point decode on
        those features, rel-max < SAM_CPU_TOL (1e-3);
     then one JSON line {"sam_path": {...}} with these numbers.
 13. stage 2's distill container (run after 12, before 10's traces): SAM
     vit_h at 1024^2 with random weights from --seed; counts set to 0 just
     before and read just after each CLI run, each held to the count
     reckoned from the code (printed beside it):
     1. the MLP field: --field_type mlp --cp_rank 64 --with_sam
        --feature_container distill --sam_use_view_direction --init_ckpt
        <phase-5 workspace> on the phase-4 scene, --online_resolution 512,
        --iters 24 --cache_size 8 --cache_interval 4 (cut from 5000 steps
        and a ring of 256: the ring fills in 8 encode steps, then serves
        16 steps, 4 of which encode): K5 twice and K6 once a step and a
        64^2 feature render, K5 twice and K3 once a chunk of every 512^2
        ground-truth and eval render, K1-K4, K7, K8, K10 never;
     2. the hash-grid field: the flags of scripts/train_sam_nerf.sh, read
        out of the script, distill in place of cache, over phase 11's
        stage-1 workspace and COLMAP scene, --downscale 4 and the same
        cuts: K10 twice a chunk of every render and twice a step, K1-K9
        never;
     for each: the backbone bitwise equal to the init checkpoint, only
     SAM-branch tensors moved, [EVAL stage-2] MSE, the peak device memory;
     the step rate on a ring batch (host clock around synchronised steps),
     a ring step and an encode step (CUDA events), the stage-2 eval's
     seconds a view; the card against the CPU on one distill step over
     32 x 32 low-res rays with the same weights, the CPU handed the card's
     K10 bins (hash-grid) or K5 bins and K6 outputs (MLP): loss and samvit
     max abs <= 1e-3, the SAM branch's grads rel-max <= 1e-3; for the MLP
     field the frozen route against the composable route (loss 2e-2,
     samvit 3e-2, grads 6e-2; K8 twice on the composable route);
     3. the decode for each field: --test --decode --use_point
        --feature_container distill --val_type val_all with phase 12's
        point file: {stem}_obj_mask.npy [1, 512, 512] uint8 for each of
        the 17 views and valid_dict.json, launches as reckoned;
     then one JSON line {"distill_path": {...}}.
 14. the viewer of scripts/gui.sh and the trajectories (run after 13,
     before 10's traces), counts set to 0 just before and read just after
     each request or run and held to the count reckoned from the code
     (K10 twice a 16384-ray chunk on the hash-grid field, K5 twice and K3
     once on the MLP field):
     1. the flags of scripts/gui.sh, read out of the script, through
        cli.main with web_viewer.serve on a free port and not blocking, on
        phase 11's stage-1 workspace and scene (the hash-grid field at its
        published widths, 512x512 frames); over HTTP: GET / and /status,
        /frame at ds 1, 2 and 4 (each frame decoded from its PNG bit for
        bit the uint8 of render_view at the same pose), each part of a
        frame's latency (median of 5: the render with CUDA events and the
        host clock, the copy to the host, the PNG encode, the HTTP round
        trip); three /clicks, one negative (each point reprojected to its
        pixel within 1 px, its camera-space depth the rendered depth, rel
        1e-5), /save_points; /orbit, /scale, /pan, /fovy; /record_pose
        twice around an orbit and /save_trajectory; /spp 4 and four frames
        (the running mean of renders jittered by generators seeded 0 to
        3, rel-max 1e-6; an orbit restarts it); the crop box and its
        reset; /bg; a 64x64 frame against the same session on the CPU,
        the CPU handed the card's K10 bins (image and depth max abs <=
        1e-3);
     2. the MLP field's viewer on the phase-5 workspace (--test --gui
        --background white): the same requests, a crop box that no ray
        meets leaving a background-only frame (JAX's bar), the CPU handed
        K5's bins;
     3. decode.sh's flags (phase 12's cache, --downscale 4) with
        --point_file set to the viewer's picked_points.json;
     4. the gui branch without --test on both fields: two training ticks
        each (the step advances by the tick size, a finite loss), steps/s
        and the next tick's size;
     5. --test --render_trajectory (70 frames) and --test --circle (60)
        on the MLP field at 512x512, and --test --trajectory_root <the
        viewer's saved keyframes> --vis_pose on the hash-grid field (9
        frames at 1024x1024): the frames' names and counts, frames/s,
        whether video.mp4 was written; the PLY's vertex and edge counts;
     then one JSON line {"viewer_path": {...}}.
 15. data parallelism, LPIPS and the native COLMAP reader (run after 14,
     before 10's traces): first, beside phase 3, the level kernels K5, K1,
     K2, K3, K4 and K10 at ray counts a rank's shard gives (3128, a
     stage-3 batch's half, and 1001), each against its plain twin at the
     phase-3 bars; then one `python -m torch.distributed.run --standalone
     --nproc_per_node 1 chip_smoke.py --dp-worker <spec>` (NCCL, one rank
     a card; no fallback to gloo), whose rank runs through cli.main, counts
     set to 0 just before and read just after each run:
     a. stage 1 of the MLP field at the phase-5 flags (20 steps of 8192
        rays, the eval of PSNR, SSIM and LPIPS on the 512x512 held-out
        views): launches K1 40, K2 40, K3 20 + 16 an eval view, K4 20, K5
        32 an eval view (4 views), K6-K10 0; the eval images equal
        render_view's; the checkpoint against phase 5's, beside a second
        run without torchrun: bitwise where those two agree bit for bit,
        else the share of elements apart by > 1e-3 under 1% (JAX's bound)
        and the mean abs under 1e-3, the max abs printed (sums in another
        order differ in their last bits, and Adam's eps 1e-15 lifts such
        a difference to an lr-sized step on single elements); one step's
        grads,
        sharded and all-reduced, against the unsharded step's on one
        batch: every non-CP grad bitwise equal;
     b. the scripts' stage 3 (train_obj_nerf.sh's flags over phase 11's
        workspace, --iters 20 --ray_pair_rgb_iter 10 --downscale 4): K10
        2 a step, an error-map chunk and an eval chunk, K1-K8 0; one step
        sharded (all-reduced) against unsharded on one batch: loss,
        metrics and the mask MLP's grads bitwise equal; the error map's
        update on the card (cells drawn twice) equal to a sequential
        write; 10 sharded steps, each drawing from the map the last one
        left, every rank's batch and map bitwise rank 0's; the CLI
        against two runs without torchrun (m_grid's grads are summed by
        index_add_'s atomics, so past step 1 no run repeats bit for bit):
        step 1's losses bitwise equal, the trace's gap printed, the final
        MeanIoU within 1e-2;
     c. LPIPS (VGG16, the proxy weights) on the card against the CPU on
        (a)'s two eval images, rel 1e-4, and its time at 512x512 (CUDA
        events, median of 10) with its peak device memory;
     d. the native COLMAP reader (g++) on phase 11's scene, field by field
        equal to the Python reader, both timed;
     e. the steps/s of (a) and (b) with and without the process group at
        world size 1 (in turns in the rank's process);
     with two or more cards, (a) again at world size 2, held to world
     size 1 by the same rule, its eval metrics within 1e-4 rel, one
     step's grads within 1e-4 rel; on one card the line says that this rests on
     the CPU tests over gloo; then one JSON line {"dp_path": {...}}.
 16. scripts/bench_rich_scene.sh at its full run lengths (run after 15,
     before 10's traces): its command lines read out of the script by
     bash (script_runs) with FIELD=mlp KIND=rich ITERS=5000 SAM_SIZE=vit_b;
     the scene writer's line through the port's tools.make_synth_scene
     (24 views of 240x320), each `main.py` line through cli.main on the
     card, counts set to 0 just before and read just after each: stage 1
     (5000 steps of 8192 rays; launches K1 2 a step, K2 2 a step while the
     proposals update, K4 1, K3 1 a step + 1 a chunk of the two evals of
     the held-out views, K5 2 a chunk), stage 2's vit_b cache and the
     decode (every view: K3 1 and K5 2 a chunk), stage 3 (200 steps; K6 1
     a step and a chunk of the error-map rebuild and the eval, K5 2) and
     its --test; each stage's seconds and steps/s, the train and held-out
     PSNR, SSIM and LPIPS (the random proxy, not gated), each view's
     depth-gate residuals, MeanIoU; gates: held-out PSNR >= 26 dB, SSIM
     >= 0.90, >= 22 of 24 views valid, MeanIoU >= 0.85, every logged loss
     finite; then one JSON line {"rich_path": {...}}.
 10. the device-only torch.profiler traces of phases 5, 7, 8, 9 and 11,
     taken after every rate, since a trace slows the host's later steps;
     one JSON line with every kernel's numbers (K10's launches those of
     phases 8 and 11's stage 3) and the phases' summaries (11's under
     "scripts_path"), the device line again, and the last line {"ok":
     true, "device": {...}}.
"""
import copy
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
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data import colmap
from sanerf_hq_tpu_torch.data.colmap_native import read_model_native
from sanerf_hq_tpu_torch.data.png import decode_png, encode_png, read_png
from sanerf_hq_tpu_torch.data.provider import (load_object_masks,
                                               load_scene, resize_nearest,
                                               split_indices)
from sanerf_hq_tpu_torch.data.rays import full_frame_rays
from sanerf_hq_tpu_torch.data.sampler import (fixed_fovy_intrinsics,
                                              sam_aug_intrinsics,
                                              sample_mask_batch,
                                              sample_rgb_batch)
from sanerf_hq_tpu_torch.data.synthetic import (look_at_pose,
                                                write_colmap_scene,
                                                write_llff_scene,
                                                write_sphere_masks,
                                                write_sphere_points)
from sanerf_hq_tpu_torch.models import SANeRFField, make_field, mlp_field
from sanerf_hq_tpu_torch.models.fields import (feature_grid_spec,
                                               lightweight_mask_grid_spec,
                                               main_grid_spec, prop_grid_spec)
from sanerf_hq_tpu_torch.ops import cuda_lib, fused_mlp
from sanerf_hq_tpu_torch.ops import ray as ray_ops
from sanerf_hq_tpu_torch.ops import render_level as rl
from sanerf_hq_tpu_torch.ops.composite import (compute_weights, distort_loss,
                                               proposal_loss)
from sanerf_hq_tpu_torch.ops.contraction import contract
from sanerf_hq_tpu_torch.ops.fused_mlp import fused_freq_mlp
from sanerf_hq_tpu_torch.ops import hashgrid as hg_ops
from sanerf_hq_tpu_torch.ops.hashgrid import (hash_encode, hash_encode_cuda,
                                              hash_encode_unit)
from sanerf_hq_tpu_torch.ops.ray import (near_far_from_aabb, spacing_fn,
                                         spacing_fn_inv, stratified_queries)
from sanerf_hq_tpu_torch.ops.sample_pdf import (sample_pdf_lookup,
                                                sample_pdf_lookup_ref)
from sanerf_hq_tpu_torch.ops.sh import sh_encode
from sanerf_hq_tpu_torch.render import web_viewer
from sanerf_hq_tpu_torch.render.gui_api import InteractiveSession
from sanerf_hq_tpu_torch.render.renderer import RenderSettings, render_rays
from sanerf_hq_tpu_torch.sam import SamPredictor, build_sam
from sanerf_hq_tpu_torch.tools import make_synth_scene
from sanerf_hq_tpu_torch.train import metrics as M
from sanerf_hq_tpu_torch.train import stages
from sanerf_hq_tpu_torch.train.checkpoints import CheckpointManager
from sanerf_hq_tpu_torch.train.lpips import make_lpips_fn, random_lpips_params
from sanerf_hq_tpu_torch.train.steps import (_grid_regularizers,
                                             make_mask_train_step,
                                             make_rgb_train_step,
                                             make_sam_distill_step,
                                             mask_losses,
                                             update_proposal_at)
from sanerf_hq_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "sanerf_hq_tpu_torch/csrc/render_level.cu"
SOURCE_BWD = "sanerf_hq_tpu_torch/csrc/render_level_bwd.cu"
SOURCE_GEMM = "sanerf_hq_tpu_torch/csrc/render_level_gemm.cuh"
SOURCE_PDF = "sanerf_hq_tpu_torch/csrc/sample_pdf.cu"
SOURCE_MLP = "sanerf_hq_tpu_torch/csrc/fused_mlp.cu"
SOURCE_HASH = "sanerf_hq_tpu_torch/csrc/hashgrid.cu"
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
            "K10": sample_pdf_lookup, "K11": hash_encode_cuda,
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
    # need_geo=False, the distill container's form (phase 13): K3's
    # outputs, bit for bit, and no trunk features
    got_n = rl.fused_final_level_frozen(*call, **args3, need_geo=False)
    want_n = rl.final_level_frozen_ref(*call, **args3, need_geo=False)
    torch.cuda.synchronize()
    assert got_n[4] is None and want_n[4] is None
    rels_n = {}
    for name, a, b_, k3 in zip(("f_image", "depth", "weights_sum", "weights"),
                               got_n, want_n, k3_out):
        assert torch.equal(a, k3), f"K6 need_geo=False {name} differs from K3"
        rels_n[name] = rel_max(a, b_)
        assert rels_n[name] < 2e-2, (name, rels_n[name])
    ms_n = cuda_ms(lambda: rl.fused_final_level_frozen(*call, **args3,
                                                       need_geo=False))
    plain_n = cuda_ms(lambda: rl.final_level_frozen_ref(*call, **args3,
                                                        need_geo=False))
    bms_n, by_n = bound_at(N, got_n[:4])
    print("[kernel] K6 need_geo=False: rel-max err " + ", ".join(
        f"{k} {v:.3e}" for k, v in rels_n.items()) + " (< 2e-2); f_image, "
          f"depth, weights_sum, weights bitwise equal to K3's; {ms_n:.4f} ms "
          f"at {N} rays, plain twin {plain_n:.4f} ms, bound {bms_n:.4f} ms "
          f"({by_n})", flush=True)
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
                                             "bound_by": by_b},
                          "need_geo_false": {
                              "ms": ms_n, "plain_ms": plain_n,
                              "bound_ms": bms_n, "bound_by": by_n,
                              "rel_max_err": max(rels_n.values()),
                              "equal_to_K3": True}}}


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
          + f" (< 2e-2); dW and dCP bitwise equal over two launches (dCP "
          f"max abs difference {cp_run_diff:.3e}); {ms:.4f} ms, "
          f"plain twin {plain:.4f} ms, bound {bms:.4f} ms ({by}, {macs} MAC "
          "a sample)", flush=True)
    k4 = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
          "max_abs_err": abs_err, "rel_max_err": max(rels.values()),
          "dcp_run_to_run_max_abs": cp_run_diff}
    # the CP grads' chunks are summed in chunk order
    assert cp_run_diff == 0.0, f"K4 dCP moved between launches {cp_run_diff}"
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
    grads are left out: earlier builds summed them with atomics, and the
    digests compare across commits).  Builds whose device code
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


# K11's shapes: (cell, encode, spec, points, the table learns) for each
# encode of a stage-1 step (8192 rays: proposals at 128 and 64 samples, the
# main grid at 32) and of a stage-3 step (6256 rays; the backbone frozen)
K11_SHAPES = (
    ("stage1", "prop 0", prop_grid_spec(128), BATCH * 128, True),
    ("stage1", "prop 1", prop_grid_spec(256), BATCH * 64, True),
    ("stage1", "main", main_grid_spec(2.0), BATCH * 32, True),
    ("stage3", "prop 0", prop_grid_spec(128), MASK_BATCH * 128, False),
    ("stage3", "prop 1", prop_grid_spec(256), MASK_BATCH * 64, False),
    ("stage3", "main", main_grid_spec(2.0), MASK_BATCH * 32, False),
    ("stage3", "m_grid", feature_grid_spec(), MASK_BATCH * 32, True))


def hash_points(dev, n, bound, seed):
    """n points as a step's samples come: 32 a ray, each ray a segment
    through the contracted cube [-bound, bound]."""
    g = torch.Generator(dev).manual_seed(seed)
    rays = -(-n // 32)
    o = (torch.rand(rays, 1, 3, generator=g, device=dev) * 2 - 1) * bound
    d = F.normalize(torch.randn(rays, 1, 3, generator=g, device=dev), dim=-1)
    t = torch.linspace(0.0, 0.5 * bound, 32, device=dev)[None, :, None]
    return (o + d * t).clamp(-bound, bound).reshape(-1, 3)[:n].contiguous()


def check_hash_kernel(dev):
    """Phase 3, K11 against its plain twin at the cells' shapes: each
    encode's forward and, where the table learns, backward on the device
    alone (CUDA graph), a forward call from the host (CUDA events), the
    twin's forward and backward, the bound in bytes (each point, output and
    dL/dout once, each row the points touch read once; the backward's rows
    read and written once; the gradient's memset, an aten launch, timed
    with the backward but left out of the bound), the output's max abs gap
    and whether it equals the twin's bit for bit, the table grads' rel-max
    gap beside the twin's own spread over two runs.  The headline numbers
    are the sums over a stage-1 step's three encodes."""
    bound_w = 2.0  # the field's grid_bound
    res = {"per_shape": {}}
    for cell, enc, spec, n, learns in K11_SHAPES:
        L, C = spec.num_levels, spec.level_dim
        g = torch.Generator(dev).manual_seed(n)
        table = (torch.rand(spec.total_params, spec.row_dim, generator=g,
                            device=dev) * 2e-4 - 1e-4).contiguous()
        x = hash_points(dev, n, bound_w, seed=n)
        cot = torch.randn(n, spec.output_dim, generator=g, device=dev)
        out, rows, _ = hash_encode_cuda(table, x, spec, bound_w, debug=True)
        u = (x + bound_w) / (2.0 * bound_w)
        twin = hash_encode_unit(table, u, spec)
        torch.cuda.synchronize()
        err = (out - twin).abs().max().item()
        equal = torch.equal(out, twin)
        assert err <= 1e-9, f"K11 {cell} {enc}: max abs gap {err}"
        touched = torch.unique(rows).numel()
        row_b = spec.row_dim * 4
        fwd_bytes = n * 12 + n * L * C * 4 + touched * row_b
        fwd = graph_ms(lambda: hg_ops._fwd(table, x, spec, bound_w, L))
        call = cuda_ms(lambda: hash_encode(table, x, spec, bound_w))
        plain = cuda_ms(lambda: hash_encode_unit(table, u, spec))
        row = {"fwd_ms": fwd, "call_ms": call, "plain_fwd_ms": plain,
               "points": n, "touched_rows": touched,
               "fwd_bound_ms": bound(fwd_bytes, 0, 0)[0],
               "max_abs_err": err, "bitwise_equal": equal}
        if learns:
            bwd = graph_ms(lambda: hg_ops._bwd(x, cot, table.shape, spec,
                                               bound_w, L))

            def twin_grad():
                t = table.clone().requires_grad_()
                (hash_encode_unit(t, u, spec) * cot).sum().backward()
                return t.grad

            t1 = table.clone().requires_grad_()
            (hash_encode(t1, x, spec, bound_w) * cot).sum().backward()
            ga, gb = twin_grad(), twin_grad()
            plain_fb = cuda_ms(twin_grad)
            torch.cuda.synchronize()
            row.update(bwd_ms=bwd, plain_fwd_bwd_ms=plain_fb,
                       bwd_bound_ms=bound(n * 12 + n * L * C * 4
                                          + 2 * touched * row_b, 0, 0)[0],
                       grad_rel_max=rel_max(t1.grad, ga),
                       twin_spread_rel_max=rel_max(gb, ga))
            assert row["grad_rel_max"] <= 1e-5, (cell, enc, row)
        key = f"{cell} {enc}"
        res["per_shape"][key] = row
        print(f"[kernel] K11 hash_encode_cuda {key} ({n} points, {L} x {C}, "
              f"2^{spec.log2_hashmap_size}, {touched} rows touched): "
              f"forward {fwd:.4f} ms on the device ({call:.4f} ms a call "
              f"from the host), bound {row['fwd_bound_ms']:.4f} ms (bytes); "
              + (f"backward {row['bwd_ms']:.4f} ms with the gradient's "
                 f"memset, bound {row['bwd_bound_ms']:.4f} ms; "
                 f"grads rel-max {row['grad_rel_max']:.2e} (the twin's own "
                 f"spread {row['twin_spread_rel_max']:.2e}); twin forward "
                 f"and backward {row['plain_fwd_bwd_ms']:.4f} ms; "
                 if learns else "")
              + f"twin forward {plain:.4f} ms; output max abs gap "
              f"{err:.2e} (bitwise equal {equal})", flush=True)
        del table, x, cot, out, rows, u, twin
        torch.cuda.empty_cache()
    for cell in ("stage1", "stage3"):
        shapes = [v for k, v in res["per_shape"].items()
                  if k.startswith(cell)]
        res[cell] = {k: sum(v.get(k, 0.0) for v in shapes) for k in (
            "fwd_ms", "bwd_ms", "call_ms", "fwd_bound_ms", "bwd_bound_ms",
            "plain_fwd_ms", "plain_fwd_bwd_ms")}
        print(f"[kernel] K11 a {cell} step's encodes: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res[cell].items()), flush=True)
    s1 = res["stage1"]
    res.update(ms=s1["fwd_ms"] + s1["bwd_ms"],
               bound_ms=s1["fwd_bound_ms"] + s1["bwd_bound_ms"],
               bound_by="bytes", plain_ms=s1["plain_fwd_bwd_ms"],
               max_abs_err=max(v["max_abs_err"]
                               for v in res["per_shape"].values()))
    return res


HG_GROUPS = (("K11", ("hash_encode_fwd", "hash_encode_bwd")),
             ("K10", ("sample_pdf_lookup",)),
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
    # K11: three encodes forward and backward a step, three forward an
    # eval chunk
    assert launches["K11"] == 6 * n + 3 * per_view * views, launches
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
    assert test_launches["K11"] == 3 * 2 * per_view, test_launches
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
          f"K10 {test_launches['K10']} (2 a chunk, {2 * per_view} chunks), "
          f"K11 {test_launches['K11']} (3 a chunk); "
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
SCRIPTS_GROUPS = (("K11", ("hash_encode_fwd", "hash_encode_bwd")),
                  ("K10", ("sample_pdf_lookup",)),
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


def scripts_env(root):
    """The SANERFHQ_* variables of the scripts over a tree under root."""
    return {"SANERFHQ_DATA_PATH": os.path.join(root, "scene"),
            "SANERFHQ_WORKSPACE_ROOT": os.path.join(root, "ws"),
            "SANERFHQ_SCENE": "sphere",
            "SANERFHQ_MASK_PATH": os.path.join(root, "masks"),
            "SANERFHQ_INIT_CKPT": os.path.join(root, "ws", "rgb_nerf",
                                               "sphere")}


def write_scripts_scene(root, view):
    """The scripts' COLMAP scene under root (17 views, images_4/ at view x
    view, images/ and the sphere masks at 4x that) and the scripts'
    relative --test_view_path, written there and passed by its absolute
    path."""
    env, full = scripts_env(root), view * SCRIPTS_DS
    write_colmap_scene(env["SANERFHQ_DATA_PATH"], n_views=17, H=view,
                       W=view, downscale=SCRIPTS_DS)
    write_sphere_masks(env["SANERFHQ_MASK_PATH"], n_views=17, H=full,
                       W=full)
    with open(os.path.join(root, "example_test_views.json"), "w") as f:
        json.dump(["v00", "v16"], f)


def obj_argv(root, ws):
    """scripts/train_obj_nerf.sh's flags over the tree under root, in
    workspace ws, cut to DP_STEPS steps (the ray-pair loss and the error
    map's rebuild every DP_RAY_PAIR_ITER)."""
    a = script_argv("train_obj_nerf.sh", scripts_env(root))
    a[a.index("--test_view_path") + 1] = os.path.join(
        root, "example_test_views.json")
    a[a.index("--workspace") + 1] = ws
    return a + ["--iters", str(DP_STEPS), "--ray_pair_rgb_iter",
                str(DP_RAY_PAIR_ITER), "--downscale", str(SCRIPTS_DS)]


def scripts_path(work):
    """Phase 11: the three scripts without SAM on a COLMAP scene, through
    the CLI with the flags read out of scripts/*.sh, then the stage-3
    step's rate and parts, the lightweight, packed and feat_rep variants
    and the card against the CPU."""
    root = os.path.join(work, "scripts")
    env = scripts_env(root)
    scene, masks_dir = env["SANERFHQ_DATA_PATH"], env["SANERFHQ_MASK_PATH"]
    n_views, full = 17, VIEW * SCRIPTS_DS
    t0 = time.perf_counter()
    write_scripts_scene(root, VIEW)
    test_views = os.path.join(root, "example_test_views.json")
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


SAM_CPU_TOL = 1e-3  # card against CPU at vit_b: rel-max, fp32, TF32 off


def sam_path(work):
    """Phase 12: stage 2 (the SAM feature cache) and the decode through the
    CLI with the flags of scripts/train_sam_nerf.sh and decode.sh at vit_h
    (1024^2 input, random weights from --seed) over phase 11's stage-1
    workspace and COLMAP scene, --downscale 4 appended (512x512 views);
    then SAM's own times at vit_h and the card against the CPU at vit_b."""
    root = os.path.join(work, "scripts")
    env = {"SANERFHQ_DATA_PATH": os.path.join(root, "scene"),
           "SANERFHQ_WORKSPACE_ROOT": os.path.join(root, "ws"),
           "SANERFHQ_SCENE": "sphere",
           "SANERFHQ_INIT_CKPT": os.path.join(root, "ws", "rgb_nerf",
                                              "sphere")}
    scene = env["SANERFHQ_DATA_PATH"]
    cut = ["--downscale", str(SCRIPTS_DS)]
    s = load_scene(scene, "mip", SCRIPTS_DS, enable_cam_center=True,
                   load_images=False)
    n_views = s.poses.shape[0]
    point_file = os.path.join(root, "example_points.json")
    pts = write_sphere_points(point_file, s.pts3d, s.poses)
    per_view = -(-VIEW * VIEW // CHUNK)
    out = {"views": n_views, "view": [VIEW, VIEW], "prompts": len(pts),
           "launches": {}}

    # 1. stage 2: scripts/train_sam_nerf.sh, the feature cache
    argv2 = script_argv("train_sam_nerf.sh", env) + cut
    torch.cuda.reset_peak_memory_stats()
    t2, dt2, launches = run_cli(argv2)
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 30
    # the field's SAM branch is built with --with_sam (the distill
    # container trains it) and nothing else is trainable
    assert t2.backbone_frozen and all(
        p.requires_grad == n_.startswith(SAM_BRANCH)
        for n_, p in t2.model.named_parameters())
    assert t2.cfg.sam_model_type == "vit_h" and t2.cfg.with_sam
    assert launches["K10"] == 2 * per_view * n_views, launches
    for k in LEVEL_KERNELS + ("K8",):
        assert launches[k] == 0, launches
    ws = t2.cfg.workspace
    cache = os.path.join(ws, "sam_cache")
    names = sorted(os.listdir(cache))
    assert names == [f"v{i:02d}.npy" for i in range(n_views)], names
    for n_ in names:
        f = np.load(os.path.join(cache, n_))
        assert f.shape == (64, 64, 256) and f.dtype == np.float32, f.shape
        assert np.isfinite(f).all(), n_
    print(f"[sam] 1. scripts/train_sam_nerf.sh {' '.join(argv2[1:])}: "
          f"{n_views} views of {VIEW}x{VIEW} rendered and encoded at vit_h "
          f"(1024^2) in {dt2:.2f} s ({dt2 / n_views:.3f} s a view, the "
          f"SAM build and the scene load included); launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items())
          + f"; sam_cache/ {len(names)} x [64, 64, 256] float32; peak "
          f"device memory {peak2:.3f} GiB", flush=True)
    out["launches"]["stage2"] = launches
    out.update(stage2_seconds=dt2, stage2_s_a_view=dt2 / n_views,
               stage2_peak_gib=peak2)
    del t2

    # 2. the decode: scripts/decode.sh
    argv3 = script_argv("decode.sh", env) + cut
    argv3[argv3.index("--point_file") + 1] = point_file
    torch.cuda.reset_peak_memory_stats()
    t3, dt3, launches = run_cli(argv3)
    peak3 = torch.cuda.max_memory_allocated() / 2 ** 30
    assert t3.cfg.decode and t3.cfg.use_point and t3.backbone_frozen
    assert launches["K10"] == 2 * per_view * n_views, launches
    for k in LEVEL_KERNELS + ("K8",):
        assert launches[k] == 0, launches
    dec = os.path.join(ws, "object_masks")
    with open(os.path.join(dec, "valid_dict.json")) as f:
        valid = json.load(f)
    stems = [f"v{i:02d}" for i in range(n_views)]
    assert sorted(valid) == stems, valid
    fg = {}
    for stem in stems:
        m = np.load(os.path.join(dec, f"{stem}_obj_mask.npy"))
        assert m.shape == (1, VIEW, VIEW) and m.dtype == np.uint8, m.shape
        assert read_png(os.path.join(dec, f"{stem}_rgb.png")).shape == (
            VIEW, VIEW, 3)
        fg[stem] = float(m.mean())
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        gate = [l_.strip() for l_ in f if l_.startswith("[decode] v")]
    n_valid = sum(valid.values())
    print(f"[sam] 2. scripts/decode.sh {' '.join(argv3[1:])}: {n_views} "
          f"views decoded from the cache with {len(pts)} prompts in "
          f"{dt3:.2f} s ({dt3 / n_views:.3f} s a view); launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; valid {n_valid}/{n_views} at depth_tol 0.05; mask "
          f"foreground share by view {fg}; peak device memory "
          f"{peak3:.3f} GiB", flush=True)
    for line in gate:
        print(f"[sam]    {line}", flush=True)
    assert n_valid >= 1, gate
    out["launches"]["decode"] = launches
    out.update(decode_seconds=dt3, decode_s_a_view=dt3 / n_views,
               decode_peak_gib=peak3, valid_views=n_valid,
               mask_foreground=fg)
    view = (np.clip(t3.render_view(s.poses[0], s.intrinsics[0], VIEW,
                                   VIEW)["image"].reshape(VIEW, VIEW, 3),
                    0, 1) * 255).astype(np.uint8)
    del t3

    # 3. SAM's own times at vit_h (CUDA events, median of 10 after 2
    # warm-up calls): set_image on a 512x512 view, the encoder alone,
    # predict with 1 and 5 points for sam and sam_hq (sam_hq's features
    # from set_image)
    torch.cuda.empty_cache()
    times, peaks = {}, {}
    coords = np.array([[256, 256], [200, 300], [320, 180], [150, 150],
                       [400, 420]])
    for hq in (False, True):
        tag = "sam_hq" if hq else "sam"
        t0 = time.perf_counter()
        sam = build_sam("vit_h", hq=hq, seed=0, device="cuda")
        torch.cuda.synchronize()
        times[f"{tag} build s"] = time.perf_counter() - t0
        pred = SamPredictor(sam)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times[f"{tag} set_image ms"] = cuda_ms(lambda: pred.set_image(view))
        peaks[tag] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        if not hq:
            x, _ = pred.preprocess(view)
            times["encoder ms"] = cuda_ms(lambda: pred.encode(x))
        for k in (1, 5):
            times[f"{tag} predict {k} pt ms"] = cuda_ms(
                lambda: pred.predict(point_coords=coords[:k],
                                     point_labels=np.ones(k)))
        m, iou, low = pred.predict(point_coords=coords[:5],
                                   point_labels=np.ones(5))
        assert m.shape == ((4 if hq else 3), VIEW, VIEW), m.shape
        assert np.isfinite(iou).all() and np.isfinite(low).all()
        weights_gib = sum(p.numel() for p in sam.parameters()) * 4 / 2 ** 30
        out[f"{tag}_weights_gib"] = weights_gib
        del sam, pred
        torch.cuda.empty_cache()
    print("[sam] 3. vit_h at 1024^2, fp32, TF32 off (CUDA events, median of "
          "10 after 2 warm-up): " + ", ".join(
              f"{k} {v:.3f}" for k, v in times.items())
          + "; peak device memory set_image adds over the weights: "
          + ", ".join(f"{k} {v:.3f} GiB" for k, v in peaks.items())
          + f" (weights sam {out['sam_weights_gib']:.3f} GiB, sam_hq "
          f"{out['sam_hq_weights_gib']:.3f} GiB) on {device_line()}",
          flush=True)
    out.update(times=times, set_image_peak_gib=peaks)

    # 4. the card against the CPU at vit_b: one 1024^2 image through the
    # encoder (features and the four global blocks' outputs) and the
    # low-res logits of a 5-point decode on those features
    sam = build_sam("vit_b", seed=0, device="cuda")
    cpu = build_sam("vit_b", device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in sam.state_dict().items()},
                        assign=True)
    gp, cp_ = SamPredictor(sam), SamPredictor(cpu)
    img = np.clip(read_png(os.path.join(scene, "images", "v03.png"))
                  [:, :, :3], 0, 255).astype(np.uint8)
    x, _ = gp.preprocess(img)
    feats, interm = gp.encode(x)
    t0 = time.perf_counter()
    feats_c, interm_c = cp_.encode(x.cpu())
    cpu_s = time.perf_counter() - t0
    errs = {"features": rel_max(feats.cpu(), feats_c)}
    for i, (a, b) in enumerate(zip(interm, interm_c)):
        errs[f"interm {i}"] = rel_max(a.cpu(), b)
    c = torch.as_tensor(coords.astype(np.float32) * 2)[None]
    lbl = torch.ones(1, 5, dtype=torch.int32)
    low, iou = gp.decode(feats, c.cuda(), lbl.cuda())
    low_c, iou_c = cp_.decode(feats_c, c, lbl)
    errs["low-res logits"] = rel_max(low.cpu(), low_c)
    errs["iou"] = rel_max(iou.cpu(), iou_c)
    worst = max(errs.values())
    print(f"[sam] 4. the card against the CPU at vit_b, one 1024^2 image "
          f"(the CPU encoder {cpu_s:.2f} s): rel-max " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bar {SAM_CPU_TOL})", flush=True)
    assert worst < SAM_CPU_TOL, errs
    out["card_vs_cpu_rel_max"] = errs
    del sam, cpu, gp, cp_
    torch.cuda.empty_cache()
    return out


DISTILL_STEPS = 24  # distill --iters, cut from the scripts' 5000
# the ring cut from 256 to 8 (encoded every 4th step, as the scripts'), and
# one checkpoint a run, not the 20 of --save_cnt (a step each at 24 steps)
DISTILL_CUT = ("--cache_size", "8", "--cache_interval", "4", "--save_cnt",
               "1")
DISTILL_CPU_HW = 32  # the card-vs-CPU distill step: a 32 x 32 feature map
SAM_BRANCH = ("cp_s_", "s_grid", "samvit_")


def distill_encodes(iters, size, interval):
    """The steps of a distill run that encode, as train_sam_distill counts
    them: every step until the ring holds `size` batches, then every
    `interval`-th."""
    n = 0
    for s_ in range(iters):
        if not (size > 0 and n >= size and s_ % interval != 0):
            n += 1
    return n


def distill_expected(field_kind, steps, encodes, n_val, R, n_dec, view):
    """Launches reckoned from the code, for the distill CLI run (steps
    distill steps, encodes ground-truth renders of an R x R frame, the
    stage-2 eval of n_val views: an R x R RGB render and a 64^2 feature
    render each) and for the decode (n_dec views: a view x view RGB
    render and a 64^2 feature render each): the MLP field's steps and
    feature renders take the frozen route (K5 twice, K6 once), its RGB
    renders the inference route (K5 twice a chunk, K3 once); the hash-grid
    field's every render K10 twice a chunk."""
    per_r = -(-R * R // CHUNK)
    per_view = -(-view * view // CHUNK)
    feat = -(-64 * 64 // CHUNK)
    run = {k: 0 for k in COUNTERS}
    dec = dict(run)
    if field_kind == "mlp":
        run["K5"] = 2 * steps + 2 * per_r * encodes + 2 * n_val * (
            per_r + feat)
        run["K6"] = steps + n_val * feat
        run["K3"] = per_r * (encodes + n_val)
        dec.update(K5=2 * n_dec * (per_view + feat), K6=n_dec * feat,
                   K3=n_dec * per_view)
    else:
        run["K10"] = 2 * steps + 2 * per_r * encodes + 2 * n_val * (
            per_r + feat)
        dec["K10"] = 2 * n_dec * (per_view + feat)
    return run, dec


def check_counts(tag, got, want):
    """Every kernel's launches against the reckoning `want` (0 where it
    has none), printed beside it after `tag` ("[phase] what")."""
    kernels = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K10")
    want = {k: want.get(k, 0) for k in kernels}
    print(f"{tag} launches read " + ", ".join(
        f"{k} {got[k]}" for k in kernels)
          + "; reckoned " + ", ".join(
              f"{k} {v}" for k, v in want.items() if v), flush=True)
    for k in kernels:
        assert got[k] == want[k], (tag, k, got, want)


def distill_cli(tag, field_kind, argv, init):
    """A distill CLI run, its launches held to the reckoned counts, the
    backbone to the init checkpoint's tensors `init`, and the stage-2 eval
    line.  Returns (trainer, numbers, the training views, the held-out
    views)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t, dt, launches = run_cli(argv)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = t.cfg
    assert t.backbone_frozen and t.state.step == DISTILL_STEPS
    assert cfg.feature_container == "distill" and cfg.sam_use_view_direction
    steps, ring = DISTILL_STEPS, (cfg.cache_size, cfg.cache_interval)
    encodes = distill_encodes(steps, *ring)
    scene = load_scene(cfg.path, cfg.data_type, cfg.downscale, cfg.scale,
                       cfg.offset, cfg.enable_cam_center, cfg.bound)
    val = cli._subset(scene, split_indices(scene.poses.shape[0],
                                           cfg.test_split, cfg.val_type))
    train = cli._subset(scene, split_indices(scene.poses.shape[0], "train"))
    n_val = val.poses.shape[0]
    want, _ = distill_expected(field_kind, steps, encodes, n_val,
                               cfg.online_resolution, 0, scene.H)
    check_counts(f"[distill] {tag} distill run", launches, want)
    state = t.model.state_dict()
    for name, p in init.items():
        assert torch.equal(state[name].cpu(), p), f"backbone {name} moved"
    ema = t.state.ema_model.state_dict()
    moved = sorted(n_ for n_, p in t.model.named_parameters()
                   if not torch.equal(p, ema[n_]))
    assert moved and all(n_.startswith(SAM_BRANCH) for n_ in moved), moved
    with open(os.path.join(cfg.workspace, "log_ngp.txt")) as f:
        log = f.read()
    assert "[EVAL stage-2] MSE = " in log, log[-2000:]
    mse = float(log.split("[EVAL stage-2] MSE = ")[-1].split()[0])
    hist = t.stats["distill"]
    assert all(np.isfinite(v["loss"]) for _, v in hist), hist
    print(f"[distill] {tag}: {' '.join(argv[1:])}: {steps} steps ({encodes} "
          f"encodes of a {cfg.online_resolution}^2 render at vit_h, the "
          f"rest from the ring), the stage-2 eval of {n_val} views in "
          f"{dt:.2f} s; backbone: all {len(init)} tensors bitwise equal to "
          f"the init checkpoint; moved {len(moved)} SAM-branch tensors; loss "
          f"step {hist[0][0]} {hist[0][1]['loss']:.5f}, step {hist[-1][0]} "
          f"{hist[-1][1]['loss']:.5f}; [EVAL stage-2] MSE {mse:.6f}; peak "
          f"device memory {peak:.3f} GiB", flush=True)
    res = {"cli_seconds": dt, "encodes": encodes, "launches": launches,
           "eval_mse": mse, "peak_gib": peak, "loss_first": hist[0][1]["loss"],
           "loss_last": hist[-1][1]["loss"]}
    return t, res, train, val


def distill_run(tag, field_kind, argv, dec_argv, init, sam, n_dec):
    """One field through phase 13: the distill CLI run and its checks, the
    rates, the card against the CPU, and the decode from rendered
    features."""
    t, res, train, val = distill_cli(tag, field_kind, argv, init)
    cfg, n_val = t.cfg, val.poses.shape[0]
    _, want_dec = distill_expected(field_kind, DISTILL_STEPS, res["encodes"],
                                   n_val, cfg.online_resolution, n_dec,
                                   val.H)

    # the rates: a ring batch's step (host clock around synchronised
    # steps, 20 after 3 warm-up), an encode step and a ring step (CUDA
    # events), the stage-2 eval a view (host clock)
    pred = SamPredictor(sam)
    R = cfg.online_resolution
    step = make_sam_distill_step(t.model, cfg,
                                 frozen_backbone=t.backbone_frozen)
    rae = stages.make_render_and_encode(t, sam, R, pred.img_size)
    host = torch.Generator().manual_seed(5)
    gen = torch.Generator(t.device).manual_seed(5)

    def draw(feat_hw=64):
        vi = int(torch.randint(train.poses.shape[0], (), generator=host))
        return stages.distill_batch(t, train.poses[vi],
                                    sam_aug_intrinsics(host, R), pred, rae,
                                    feat_hw=feat_hw)

    batch = draw()
    for _ in range(3):
        step(t.state, batch, gen)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        m = step(t.state, batch, gen)
    torch.cuda.synchronize()
    sps = reps / (time.perf_counter() - t0)
    assert np.isfinite(float(m["loss"]))
    ring_ms = cuda_ms(lambda: step(t.state, batch, gen))
    encode_ms = cuda_ms(lambda: step(t.state, draw(), gen), reps=3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages.evaluate_sam_features(t, val, pred)
    torch.cuda.synchronize()
    eval_s = (time.perf_counter() - t0) / n_val
    # the uncut run's mix at --cache_interval 4: one encode in four steps
    mix = 4 / (encode_ms + 3 * ring_ms) * 1e3
    print(f"[distill] {tag}: {sps:.3f} steps/s on a ring batch ({1e3 / sps:.2f}"
          f" ms a step, host clock, mean of {reps} after 3 warm-up); CUDA "
          f"events: a ring step {ring_ms:.3f} ms, an encode step "
          f"{encode_ms:.3f} ms (render, vit_h, the step); one encode in four "
          f"steps: {mix:.3f} steps/s; the stage-2 eval {eval_s:.3f} s a view",
          flush=True)
    res.update(steps_per_s=sps, ring_step_ms=ring_ms, encode_step_ms=encode_ms,
               steps_per_s_one_encode_in_four=mix, eval_s_a_view=eval_s)

    res["card_vs_cpu"] = distill_card_vs_cpu(t, field_kind, draw(
        DISTILL_CPU_HW), tag)
    if field_kind == "mlp":
        res["routes"] = distill_routes(t, batch)
    del step, rae, pred
    torch.cuda.empty_cache()

    # the decode from the rendered features
    t_dec, dt_dec, launches = run_cli(dec_argv)
    assert t_dec.cfg.feature_container == "distill" and t_dec.resumed
    assert t_dec.state.step == DISTILL_STEPS
    check_counts(f"[distill] {tag} decode", launches, want_dec)
    dec = os.path.join(t_dec.cfg.workspace, "object_masks")
    with open(os.path.join(dec, "valid_dict.json")) as f:
        valid = json.load(f)
    assert len(valid) == n_dec, valid
    for stem in valid:
        m_ = np.load(os.path.join(dec, f"{stem}_obj_mask.npy"))
        assert m_.shape == (1, VIEW, VIEW) and m_.dtype == np.uint8, m_.shape
        assert read_png(os.path.join(dec, f"{stem}_rgb.png")).shape == (
            VIEW, VIEW, 3)
    print(f"[distill] {tag} decode: {' '.join(dec_argv[1:])}: {n_dec} views "
          f"decoded from rendered features in {dt_dec:.2f} s "
          f"({dt_dec / n_dec:.3f} s a view, the SAM build and the scene load "
          f"included); valid {sum(valid.values())}/{n_dec}; "
          "{stem}_obj_mask.npy [1, 512, 512] uint8 and valid_dict.json "
          "written", flush=True)
    res.update(decode_seconds=dt_dec, decode_s_a_view=dt_dec / n_dec,
               decode_launches=launches, decode_valid=sum(valid.values()))
    del t, t_dec
    torch.cuda.empty_cache()
    return res


def distill_card_vs_cpu(t, field_kind, batch, tag):
    """One distill step over DISTILL_CPU_HW^2 low-res rays (the map resized
    to the encoder's 64 x 64 grid) on the card and on the CPU with the same
    weights, the CPU handed the card's backbone values where the card's
    kernels made them: K10's resampled bins on the hash-grid field, K5's
    bins and K6's outputs on the MLP field's frozen route.  Bars: the loss
    and samvit max abs <= 1e-3, the SAM branch's grads rel-max <= 1e-3."""
    model, cfg = t.model, t.cfg
    cpu = make_field(field_kind if field_kind == "mlp" else cfg.field_type,
                     device="cpu", grid_bound=cfg.grid_bound,
                     cp_rank=cfg.cp_rank, cp_res=cfg.cp_res,
                     density_bias=cfg.density_bias, feat_rep=cfg.feat_rep,
                     feat_rank=cfg.feat_rank, feat_res=cfg.feat_res,
                     with_sam=True,
                     sam_use_view_direction=cfg.sam_use_view_direction)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    names = [n_ for n_, _ in model.named_parameters()
             if n_.startswith(SAM_BRANCH)]
    recorded = []
    kernel_methods = ("fused_prop_next_bins", "fused_final_render_frozen")

    def run(m, d, replay):
        step = make_sam_distill_step(m, cfg, feat_hw=DISTILL_CPU_HW,
                                     frozen_backbone=t.backbone_frozen)
        b = {k: v.to(d) for k, v in batch.items()}
        if field_kind == "mlp":
            for name in kernel_methods:
                if replay:
                    outs = iter([o for n_, o in recorded if n_ == name])
                    setattr(m, name, lambda *a, outs=outs, **k: to_cpu(
                        next(outs)))
                else:
                    def spy(*a, fn=getattr(m, name), name=name, **k):
                        o = fn(*a, **k)
                        recorded.append((name, o))
                        return o
                    setattr(m, name, spy)
        else:
            if replay:
                it = iter([o for _, o in recorded])
                ray_ops.sample_pdf_lookup = lambda *a: next(it).cpu()
            else:
                def record(*a):
                    o = sample_pdf_lookup(*a)
                    recorded.append(("K10", o))
                    return o
                ray_ops.sample_pdf_lookup = record
        try:
            loss, _, out = step.loss_fn(b)
        finally:
            ray_ops.sample_pdf_lookup = sample_pdf_lookup
            for name in kernel_methods:
                m.__dict__.pop(name, None)
        params = dict(m.named_parameters())
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return (loss.item(), out["samvit"].detach().cpu(),
                [g_.cpu() for g_ in grads])

    card = run(model, t.device, False)
    handed = run(cpu, "cpu", True)
    loss_err = abs(card[0] - handed[0])
    out_err = (card[1] - handed[1]).abs().max().item()
    g_rel = {k: rel_max(a, b_) for k, a, b_ in zip(names, card[2],
                                                   handed[2])}
    what = ("K5's bins and K6's outputs" if field_kind == "mlp"
            else "K10's bins")
    print(f"[distill] {tag} card vs CPU, one step over "
          f"{DISTILL_CPU_HW}x{DISTILL_CPU_HW} low-res rays, the CPU handed "
          f"{what}: loss {card[0]:.6f} vs {handed[0]:.6f} (diff "
          f"{loss_err:.2e} <= 1e-3), samvit max abs {out_err:.2e} (<= 1e-3); "
          f"grads rel-max worst {max(g_rel.values()):.2e} (<= 1e-3): "
          + ", ".join(f"{k} {v:.2e}" for k, v in g_rel.items()), flush=True)
    assert loss_err <= 1e-3 and out_err <= 1e-3, (loss_err, out_err)
    assert max(g_rel.values()) <= 1e-3, g_rel
    return {"loss_diff": loss_err, "samvit_max_abs": out_err,
            "grad_rel_max": g_rel}


def to_cpu(o):
    """A tensor, or a tuple of tensors and None, on the CPU."""
    if isinstance(o, tuple):
        return tuple(x.cpu() if torch.is_tensor(x) else x for x in o)
    return o.cpu()


def distill_routes(t, batch):
    """The MLP field's distill step on the frozen route (K5, K6) against
    the composable route (K8 twice), at the JAX package's bars for its two
    routes: loss 2e-2, samvit 3e-2, the SAM branch's grads rel-max
    6e-2."""
    names = [n_ for n_, _ in t.model.named_parameters()
             if n_.startswith(SAM_BRANCH)]
    params = dict(t.model.named_parameters())
    res, k8 = {}, {}
    for frozen in (True, False):
        reset_counts()
        loss, _, out = make_sam_distill_step(
            t.model, t.cfg, frozen_backbone=frozen).loss_fn(batch)
        k8[frozen] = read_counts()["K8"]
        res[frozen] = (loss.item(), out["samvit"].detach(),
                       torch.autograd.grad(loss, [params[k] for k in names]))
    d_loss = abs(res[True][0] - res[False][0])
    d_out = (res[True][1] - res[False][1]).abs().max().item()
    g_rel = max(rel_max(a, b_) for a, b_ in zip(res[True][2],
                                                res[False][2]))
    print(f"[distill] mlp frozen vs composable route, one 64x64 step: loss "
          f"{res[True][0]:.6f} vs {res[False][0]:.6f} (diff {d_loss:.2e} < "
          f"2e-2), samvit max abs {d_out:.2e} (< 3e-2), SAM-branch grads "
          f"worst rel-max {g_rel:.2e} (< 6e-2); K8 launches {k8[True]} and "
          f"{k8[False]}", flush=True)
    assert d_loss < 2e-2 and d_out < 3e-2 and g_rel < 6e-2
    assert k8 == {True: 0, False: 2}, k8
    return {"loss_diff": d_loss, "samvit_max_abs": d_out,
            "grad_rel_max": g_rel}


def distill_path(work):
    """Phase 13: stage 2's distill container through the CLI for each field
    (the MLP field over the phase-5 workspace on the phase-4 scene; the
    hash-grid field with the flags of scripts/train_sam_nerf.sh, distill in
    place of cache, over phase 11's stage-1 workspace and COLMAP scene),
    then the decode from rendered features with phase 12's point file."""
    t0 = time.perf_counter()
    sam = build_sam("vit_h", seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[distill] vit_h built in {time.perf_counter() - t0:.2f} s (for "
          "the rates and the card-vs-CPU batches; each CLI run builds its "
          "own)", flush=True)
    root = os.path.join(work, "scripts")
    point_file = os.path.join(root, "example_points.json")  # phase 12's
    out = {"steps": DISTILL_STEPS, "cut": list(DISTILL_CUT),
           "online_resolution": VIEW}

    # 1. the MLP field over the phase-5 workspace
    scene = os.path.join(work, "scene")
    init_ws = os.path.join(work, "train_ws")
    ws = os.path.join(work, "distill_ws")
    common = [scene, "--field_type", "mlp", "--data_type", "llff",
              "--workspace", ws, "--seed", "0", "--cp_rank", "64",
              "--with_sam", "--feature_container", "distill",
              "--sam_use_view_direction", "--init_ckpt", init_ws]
    argv = common + ["--online_resolution", str(VIEW), "--iters",
                     str(DISTILL_STEPS), *DISTILL_CUT]
    dec_argv = common + ["--test", "--decode", "--use_point",
                         "--point_file", point_file, "--val_type",
                         "val_all"]
    out["mlp"] = distill_run("mlp", "mlp", argv, dec_argv,
                             latest_model(init_ws), sam, 17)

    # 2. the hash-grid field: scripts/train_sam_nerf.sh, distill for cache
    env = {"SANERFHQ_DATA_PATH": os.path.join(root, "scene"),
           "SANERFHQ_WORKSPACE_ROOT": os.path.join(root, "ws"),
           "SANERFHQ_SCENE": "sphere",
           "SANERFHQ_INIT_CKPT": os.path.join(root, "ws", "rgb_nerf",
                                              "sphere")}
    ws = os.path.join(root, "ws", "distill_nerf", "sphere")

    def distill_flags(argv_):
        argv_ = list(argv_)
        argv_[argv_.index("--feature_container") + 1] = "distill"
        argv_[argv_.index("--workspace") + 1] = ws
        return argv_ + ["--downscale", str(SCRIPTS_DS)]

    argv = distill_flags(script_argv("train_sam_nerf.sh", env)) + [
        "--iters", str(DISTILL_STEPS), *DISTILL_CUT]
    dec_argv = distill_flags(script_argv("decode.sh", env))
    dec_argv[dec_argv.index("--point_file") + 1] = point_file
    out["hashgrid"] = distill_run("hashgrid", "hashgrid", argv, dec_argv,
                                  latest_model(env["SANERFHQ_INIT_CKPT"]),
                                  sam, 17)
    del sam

    # 4. the MLP field's --feat_rep hashgrid (s_grid for the CP volume) and
    # the packed hash-grid field (over phase 11's 5-step packed stage 1)
    ws_p1 = os.path.join(root, "ws", "rgb_packed")
    spec = feature_grid_spec()
    out["variants"] = {}
    for tag, kind, extra, init_ws, spec_v in (
            ("mlp --feat_rep hashgrid", "mlp",
             common[1:] + ["--feat_rep", "hashgrid", "--online_resolution",
                           str(VIEW)], os.path.join(work, "train_ws"), spec),
            ("hashgrid_packed", "hashgrid",
             argv[1:] + ["--field_type", "hashgrid_packed", "--init_ckpt",
                         ws_p1], ws_p1,
             dataclasses.replace(spec, packed=True))):
        path = scene if kind == "mlp" else env["SANERFHQ_DATA_PATH"]
        ws_v = os.path.join(work, "distill_" + tag.split()[-1])
        argv_v = [path] + extra + ["--workspace", ws_v, "--iters",
                                   str(DISTILL_STEPS), *DISTILL_CUT]
        t, res, _, _ = distill_cli(tag, kind, argv_v, latest_model(init_ws))
        # the published s_grid: 5,258,512 rows of 8, packed 64 wide
        assert t.model.s_spec == spec_v, t.model.s_spec
        assert tuple(t.model.s_grid.shape) == (spec_v.total_params,
                                               spec_v.row_dim)
        print(f"[distill] {tag}: s_grid {tuple(t.model.s_grid.shape)}",
              flush=True)
        out["variants"][tag] = res
        del t
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
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


# phase 14: the viewer of scripts/gui.sh, the trajectory renders and
# --vis_pose
VIEWER_DS = (1, 2, 4)
VIEWER_CPU_DS = 8  # the card-vs-CPU frame: 64x64
VIEWER_REPS = 5  # timed frames a part, median
TRAJ_FRAMES = {"interp": 14 * 5, "circle": 60}  # 60 // 14 = 4: 5 a pair
REPLAY_FRAMES, REPLAY_RES = 9, 1024  # 2 keyframes, 8 steps: 1024x1024


def http_get(base, path):
    with urllib.request.urlopen(base + path, timeout=600) as r:
        return dict(r.headers), r.read()


def http_post(base, path, obj):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def frame_counts(kind, rays):
    """The launches of one full-frame render of `rays` rays: 2 K10 (hash
    grid) or 2 K5 and 1 K3 (MLP field) a 16384-ray chunk."""
    chunks = -(-rays // CHUNK)
    return ({"K10": 2 * chunks} if kind == "hashgrid"
            else {"K5": 2 * chunks, "K3": chunks})


class Viewer:
    """cli.main(argv) with web_viewer.serve started on a free port, not
    blocking; close() ends the server and the training thread."""

    def __init__(self, argv):
        real = web_viewer.serve
        started = {}

        def serve(session, **kw):
            kw.update(port=0, block=False)
            started["kw"] = kw
            started["r"] = real(session, **kw)
            return started["r"]

        web_viewer.serve = serve
        try:
            self.trainer, self.seconds, self.launches = run_cli(argv)
        finally:
            web_viewer.serve = real
        self.server, self.state = started["r"]
        self.points_path = started["kw"]["points_path"]
        self.sess = self.state.session
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.state.stop()

    def view(self, ds):
        """(pose, intrinsics, H, W) of the session's frame at ds."""
        cam = self.sess.camera
        H, W = cam.H // ds, cam.W // ds
        intr = cam.intrinsics / ds
        intr[2], intr[3] = W / 2, H / 2
        return cam.pose, intr, H, W

    def reference(self, ds, generator=None):
        """render_view at the session's camera, crop box and background."""
        pose, intr, H, W = self.view(ds)
        return self.trainer.render_view(pose, intr, H, W,
                                        bg_color=self.sess.bg_color,
                                        aabb=self.sess.aabb,
                                        generator=generator)


def uint8_frame(img, H, W):
    return (np.clip(img.reshape(H, W, 3), 0, 1) * 255).astype(np.uint8)


def viewer_frames(v, kind, tag):
    """GET /frame at ds 1, 2 and 4, each held bit for bit to the uint8 of
    render_view at the same pose and its launches to the reckoning; then
    each part of a frame's latency (median of VIEWER_REPS): the render
    (CUDA events and the host clock), the copy to the host, the PNG
    encode, and the HTTP round trip."""
    out = {}
    for ds in VIEWER_DS:
        pose, intr, H, W = v.view(ds)
        reset_counts()
        headers, body = http_get(v.base, f"/frame?ds={ds}")
        check_counts(f"[viewer] {tag} GET /frame?ds={ds} ({W}x{H})",
                     read_counts(), frame_counts(kind, H * W))
        assert headers["Content-Type"] == "image/png", headers
        frame = decode_png(body)
        ref = v.reference(ds)
        assert np.array_equal(frame, uint8_frame(ref["image"], H, W)), ds
        dev = v.trainer.device
        ro, rd = full_frame_rays(torch.as_tensor(pose, device=dev),
                                 torch.as_tensor(intr, device=dev), H, W)
        parts = {"render_device_ms": [], "render_host_ms": [],
                 "copy_ms": [], "png_ms": [], "http_ms": []}
        for _ in range(VIEWER_REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            e0.record()
            o = v.trainer.eval_render(ro, rd, bg_color=v.sess.bg_color)
            e1.record()
            torch.cuda.synchronize()
            h1 = time.perf_counter()
            host = {k: x.cpu().numpy() for k, x in o.items()}
            h2 = time.perf_counter()
            img = uint8_frame(host["image"], H, W)
            h3 = time.perf_counter()
            png = encode_png(img)
            h4 = time.perf_counter()
            _, body = http_get(v.base, f"/frame?ds={ds}")
            h5 = time.perf_counter()
            parts["render_device_ms"].append(e0.elapsed_time(e1))
            parts["render_host_ms"].append((h1 - h0) * 1e3)
            parts["copy_ms"].append((h2 - h1) * 1e3)
            parts["png_ms"].append((h4 - h3) * 1e3)
            parts["http_ms"].append((h5 - h4) * 1e3)
            assert png == body  # the same frame, the same bytes
        med = {k: float(np.median(x)) for k, x in parts.items()}
        med.update(png_bytes=len(png), rays=H * W,
                   mrays_per_s=H * W / med["render_host_ms"] / 1e3,
                   frames_per_s=1e3 / med["http_ms"])
        print(f"[viewer] {tag} ds={ds} ({W}x{H}), median of {VIEWER_REPS}: "
              f"render {med['render_device_ms']:.3f} ms device, "
              f"{med['render_host_ms']:.3f} ms host "
              f"({med['mrays_per_s']:.4f} Mrays/s); copy to host "
              f"{med['copy_ms']:.3f} ms; PNG encode {med['png_ms']:.3f} ms "
              f"({len(png)} bytes); HTTP round trip {med['http_ms']:.3f} ms "
              f"({med['frames_per_s']:.2f} frames/s); the frame bit for bit "
              "the uint8 of render_view", flush=True)
        out[f"ds{ds}"] = med
    return out


def viewer_picks(v, kind, tag):
    """Three right-clicks (one negative) through POST /click: each point
    projects back to its pixel within 1 px and its camera-space depth is
    the rendered depth there (rel 1e-5); a pick renders one ds=1 frame.
    Then POST /save_points."""
    pose, intr, H, W = v.view(1)
    depth = v.reference(1)["depth"].reshape(H, W)
    R, t = pose[:3, :3], pose[:3, 3]
    fx, fy, cx, cy = intr
    picks, ms = [], []
    for px, py, label in ((W // 2, H // 2, 1), (W * 3 // 8, H * 5 // 8, 0),
                          (W * 5 // 8, H * 3 // 8, 1)):
        reset_counts()
        t0 = time.perf_counter()
        p = http_post(v.base, "/click", {"x": (px + 0.5) / W,
                                         "y": (py + 0.5) / H,
                                         "label": label})["point"]
        ms.append((time.perf_counter() - t0) * 1e3)
        check_counts(f"[viewer] {tag} POST /click ({px}, {py})",
                     read_counts(), frame_counts(kind, H * W))
        pc = R.T @ (np.asarray(p, np.float64) - t)
        z = -pc[2]
        u, w_ = fx * pc[0] / z + cx, -fy * pc[1] / z + cy
        err_px = max(abs(u - (px + 0.5)), abs(w_ - (py + 0.5)))
        err_z = abs(z - depth[py, px]) / abs(depth[py, px])
        assert err_px <= 1.0 and err_z <= 1e-5, (px, py, err_px, err_z)
        picks.append({"pixel": [px, py], "label": label, "point": p,
                      "reprojection_px": float(err_px),
                      "depth_rel": float(err_z)})
    saved = http_post(v.base, "/save_points", {})
    with open(v.points_path) as f:
        pf = json.load(f)
    assert saved["n"] == 3 and len(pf["points"]) == 3
    assert pf["negative_labels"] == [1] and pf["valid_threshold"] == -1
    print(f"[viewer] {tag} picks: " + "; ".join(
        f"({p['pixel'][0]}, {p['pixel'][1]}) label {p['label']} -> "
        f"{np.round(p['point'], 4).tolist()}, reprojection "
        f"{p['reprojection_px']:.2e} px, depth rel {p['depth_rel']:.2e}"
        for p in picks) + f"; POST /click {np.median(ms):.3f} ms (median of "
          f"3); saved {v.points_path}", flush=True)
    return {"picks": picks, "click_ms": float(np.median(ms)),
            "points_file": pf}


def viewer_widgets(v, kind, tag, trajdir):
    """The page's other requests: GET / and /status, POST /orbit, /scale,
    /pan and /fovy, /record_pose twice around an orbit and
    /save_trajectory, SPP 4 (four frames, the running mean of renders
    jittered by generators seeded 0 to 3, rel-max 1e-6; an orbit restarts
    it), the crop box and its reset, /bg."""
    headers, body = http_get(v.base, "/")
    assert b"<canvas" in body and f'width="{VIEW}"'.encode() in body
    st = json.loads(http_get(v.base, "/status")[1])
    assert st["training"] is False and st["spp"] == 1, st
    cam = v.sess.camera
    pose0 = cam.pose.copy()
    for path, obj in (("/orbit", {"dx": 40, "dy": -20}),
                      ("/scale", {"delta": -1}),
                      ("/pan", {"dx": 30, "dy": 10}),
                      ("/fovy", {"value": 55})):
        assert http_post(v.base, path, obj) == {"ok": True}, path
    assert cam.fovy == 55.0 and not np.allclose(cam.pose, pose0)
    assert http_post(v.base, "/record_pose", {})["n_keyframes"] == 1
    http_post(v.base, "/orbit", {"dx": 120, "dy": 15})
    assert http_post(v.base, "/record_pose", {})["n_keyframes"] == 2
    os.makedirs(trajdir, exist_ok=True)
    saved = http_post(v.base, "/save_trajectory",
                      {"path": os.path.join(trajdir, "orbit.json")})
    assert saved["n_keyframes"] == 2

    # SPP: four jittered frames at ds=2, then the mean served as it is
    assert http_post(v.base, "/spp", {"value": 4}) == {"ok": True}
    pose, intr, H, W = v.view(2)
    spp = []
    for i in range(5):
        reset_counts()
        headers, body = http_get(v.base, "/frame?ds=2")
        check_counts(f"[viewer] {tag} SPP frame {i + 1}", read_counts(),
                     frame_counts(kind, H * W) if i < 4 else {})
        spp.append(int(headers["X-SPP"]))
    assert spp == [1, 2, 3, 4, 4], spp
    dev = v.trainer.device
    renders = [v.reference(2, torch.Generator(dev).manual_seed(s))["image"]
               .reshape(H, W, 3) for s in range(4)]
    want = np.mean(np.stack(renders).astype(np.float64), axis=0)
    err = float(np.abs(v.sess._accum - want).max() / np.abs(want).max())
    assert err <= 1e-6, err
    assert np.array_equal(decode_png(body), uint8_frame(v.sess._accum, H, W))
    jitter = float(np.abs(renders[0] - renders[1]).max())
    assert jitter > 0
    http_post(v.base, "/orbit", {"dx": 10, "dy": 0})
    headers, _ = http_get(v.base, "/frame?ds=2")
    assert headers["X-SPP"] == "1"
    http_post(v.base, "/spp", {"value": 1})

    # the crop box and its reset, then the background
    ds = 4
    before = http_get(v.base, f"/frame?ds={ds}")[1]
    depth = v.sess._last_depth.copy()
    http_post(v.base, "/aabb", {"min": [-0.05] * 3, "max": [0.05] * 3})
    st = json.loads(http_get(v.base, "/status")[1])
    assert np.allclose(st["aabb"], [-0.05] * 3 + [0.05] * 3), st
    http_get(v.base, f"/frame?ds={ds}")
    assert not np.array_equal(v.sess._last_depth, depth)  # rays cut short
    http_post(v.base, "/aabb", {"reset": True})
    assert v.sess.aabb is None
    assert http_get(v.base, f"/frame?ds={ds}")[1] == before
    assert np.array_equal(v.sess._last_depth, depth)
    assert http_post(v.base, "/bg", {"value": 0.5}) == {"ok": True}
    assert v.sess.bg_color == 0.5
    http_post(v.base, "/bg", {"value": 1.0})
    print(f"[viewer] {tag} widgets: GET / and /status; orbit, scale, pan, "
          f"fovy; 2 keyframes saved to {saved['saved']}; SPP counts {spp}, "
          f"the mean of 4 jittered renders rel-max {err:.2e} (<= 1e-6), "
          f"jitter moved the image by up to {jitter:.3e}, an orbit restarts "
          "it; the crop box changed the depths and its reset restored the "
          "frame bit for bit; /bg", flush=True)
    return {"spp_counts": spp, "spp_rel_max": err, "jitter": jitter}


def viewer_crop_empties(v, tag):
    """On a session with --background white, the JAX viewer test's check
    that a crop box empties the frame (max |clip(image) - 1| < 0.05): a
    box of 0.02 beside the camera, which no ray meets."""
    pose = v.sess.camera.pose
    c = pose[:3, 3] + 5.0 * pose[:3, 0]
    http_post(v.base, "/aabb", {"min": (c - 0.01).tolist(),
                                "max": (c + 0.01).tolist()})
    frame = v.sess.render_frame(downscale=4)
    http_post(v.base, "/aabb", {"reset": True})
    img = np.clip(frame["image"], 0, 1)
    err = float(np.abs(img - 1.0).max())
    print(f"[viewer] {tag} a crop box of 0.02 beside the camera, "
          f"--background white: max |image - 1| {err:.3e} (< 0.05), depth "
          f"max {float(frame['depth'].max()):.3e}", flush=True)
    assert err < 0.05 and np.isfinite(frame["depth"]).all()
    return err


def viewer_card_vs_cpu(v, kind, tag):
    """A ds=8 frame (64x64) of the session on the card against the same
    session on the CPU with the same EMA weights, the CPU handed the card's
    resampled bins (K10's outputs on the hash-grid field, K5's on the MLP
    field): image and depth max abs <= 1e-3."""
    t, cfg = v.trainer, v.trainer.cfg
    cpu = make_field(cfg.field_type, device="cpu", grid_bound=cfg.grid_bound,
                     cp_rank=cfg.cp_rank, cp_res=cfg.cp_res,
                     density_bias=cfg.density_bias)
    ct = Trainer("cpu", cfg.replace(device="cpu"), cpu,
                 os.path.join(cfg.workspace, "cpu_frame"), resume=False)
    ct.state.load_weights({k: x.cpu() for k, x in
                           t.state.ema_model.state_dict().items()})
    cs = InteractiveSession(ct, W=v.sess.camera.W, H=v.sess.camera.H)
    for name in ("rot", "center", "radius", "fovy"):
        setattr(cs.camera, name, copy.deepcopy(getattr(v.sess.camera, name)))
    cs.bg_color = v.sess.bg_color
    recorded = []
    card_m, cpu_m = t.state.ema_model, ct.state.ema_model
    if kind == "hashgrid":
        def record(*a):
            o = sample_pdf_lookup(*a)
            recorded.append(o)
            return o
        ray_ops.sample_pdf_lookup = record
    else:
        def spy(*a, fn=card_m.fused_prop_next_bins, **k):
            o = fn(*a, **k)
            recorded.append(o)
            return o
        card_m.fused_prop_next_bins = spy
    try:
        card = v.sess.render_frame(downscale=VIEWER_CPU_DS)
    finally:
        ray_ops.sample_pdf_lookup = sample_pdf_lookup
        card_m.__dict__.pop("fused_prop_next_bins", None)
    it = iter(recorded)
    if kind == "hashgrid":
        ray_ops.sample_pdf_lookup = lambda *a: next(it).cpu()
    else:
        cpu_m.fused_prop_next_bins = lambda *a, **k: next(it).cpu()
    try:
        host = cs.render_frame(downscale=VIEWER_CPU_DS)
    finally:
        ray_ops.sample_pdf_lookup = sample_pdf_lookup
        cpu_m.__dict__.pop("fused_prop_next_bins", None)
    err = {k: float(np.abs(card[k] - host[k]).max()) for k in ("image",
                                                              "depth")}
    print(f"[viewer] {tag} card vs CPU, a ds={VIEWER_CPU_DS} frame "
          f"({card['image'].shape[1]}x{card['image'].shape[0]}), the CPU "
          f"handed the card's {len(recorded)} resampled-bin tensors: image "
          f"max abs {err['image']:.2e}, depth max abs {err['depth']:.2e} "
          f"(<= 1e-3; depth up to {float(card['depth'].max()):.3f})",
          flush=True)
    assert max(err.values()) <= 1e-3, err
    return err


def viewer_ticks(argv, kind, tag):
    """The gui branch without --test (a session with the training views):
    two training ticks, each advancing the step by its tick size with a
    finite loss and the launches of that many steps."""
    v = Viewer(argv)
    try:
        assert v.sess.scene is not None
        out = []
        for _ in range(2):
            n, step0 = v.sess._train_steps, v.trainer.state.step
            reset_counts()
            r = v.sess.train_ticks(target_seconds=0.5)
            per = ({"K10": 2} if kind == "hashgrid" else
                   {"K1": 2, "K2": 2, "K3": 1, "K4": 1})
            want = {k: c * n for k, c in per.items()}
            got = read_counts()
            check_counts(f"[viewer] {tag} tick of {n} steps", got, want)
            for kid, parts in PARTS.items():
                assert all(got[k] == got[kid] for k in parts), got
            assert r["steps"] == n and r["step"] == step0 + n, r
            assert np.isfinite(r["loss"]), r
            print(f"[viewer] {tag} tick: {n} steps of "
                  f"{v.trainer.cfg.num_rays} rays in {r['time']:.3f} s "
                  f"({r['steps_per_sec']:.3f} steps/s), step {r['step']}, "
                  f"loss {r['loss']:.5f}; next tick {v.sess._train_steps} "
                  "steps (0.5 s)", flush=True)
            out.append({"steps": n, "steps_per_s": r["steps_per_sec"],
                        "loss": r["loss"], "next": v.sess._train_steps})
        return out
    finally:
        v.close()


def trajectory_run(argv, kind, tag, frames, names, H, W):
    """One trajectory CLI run into a fresh <workspace>/trajectory: the
    frames' names and count, their launches, frames/s, and whether the
    video was written."""
    ws = argv[argv.index("--workspace") + 1]
    d = os.path.join(ws, "trajectory")
    shutil.rmtree(d, ignore_errors=True)
    t, dt, launches = run_cli(argv)
    want = {k: frames * c for k, c in frame_counts(kind, H * W).items()}
    check_counts(f"[viewer] {tag}: {frames} frames of {W}x{H}", launches,
                 want)
    got = sorted(os.listdir(d))
    video = "video.mp4" in got
    want_files = sorted([f"{n}_{s}" for n in names
                         for s in ("rgb.png", "depth.npy")]
                        + (["video.mp4"] if video else []))
    assert got == want_files, (got[:4], want_files[:4])
    img = read_png(os.path.join(d, f"{names[0]}_rgb.png"))
    assert img.shape == (H, W, 3)
    print(f"[viewer] {tag}: {frames} frames ({names[0]} ... {names[-1]}) of "
          f"{W}x{H} in {dt:.2f} s ({frames / dt:.3f} frames/s with the PNG "
          "and depth writes); "
          + ("video.mp4 written" if video else
             "no video.mp4: imageio (or imageio-ffmpeg) is not installed, "
             "the frames stay"), flush=True)
    return {"frames": frames, "seconds": dt, "frames_per_s": frames / dt,
            "video": video, "launches": launches}


def viewer_path(work):
    """Phase 14: scripts/gui.sh through the CLI on phase 11's hash-grid
    workspace, and the MLP field's viewer on the phase-5 workspace, driven
    over HTTP; the decode of the picked points; training ticks on both
    fields; the three trajectory renders; --vis_pose."""
    t_phase = time.perf_counter()
    root = os.path.join(work, "scripts")
    env = {"SANERFHQ_DATA_PATH": os.path.join(root, "scene"),
           "SANERFHQ_WORKSPACE_ROOT": os.path.join(root, "ws"),
           "SANERFHQ_SCENE": "sphere",
           "SANERFHQ_INIT_CKPT": os.path.join(root, "ws", "rgb_nerf",
                                              "sphere")}
    trajdir = os.path.join(work, "viewer_trajectories")
    out = {}

    # 1. scripts/gui.sh on the hash-grid field (phase 11's stage 1)
    gui = script_argv("gui.sh", env)
    v = Viewer(gui)
    try:
        cfg = v.trainer.cfg
        assert v.sess.scene is None and v.trainer.resumed
        assert (v.sess.camera.W, v.sess.camera.H, v.sess.camera.radius) == (
            VIEW, VIEW, 0.5)
        check_counts("[viewer] gui.sh start", v.launches, {})
        print(f"[viewer] scripts/gui.sh {' '.join(gui[1:])}: serving "
              f"{v.base} in {v.seconds:.2f} s (resumed at step "
              f"{v.trainer.state.step}, {cfg.field_type} field)", flush=True)
        # the training cameras ring the sphere in the z = 0 plane at
        # distance 1; gui.sh's first camera looks down from +z at --radius
        # 0.5, a view the field never saw: orbit 90 degrees about the up
        # axis and zoom out to radius 0.5 * 1.1^7 = 0.974, beside the
        # training view at (1, 0.09, 0)
        http_post(v.base, "/orbit", {"dx": -0.5 * np.pi / 0.005, "dy": 0})
        http_post(v.base, "/scale", {"delta": -7})
        print(f"[viewer] camera at {np.round(v.sess.camera.pose[:3, 3], 4)}"
              , flush=True)
        hg = {"frames": viewer_frames(v, "hashgrid", "hash-grid")}
        hg.update(viewer_picks(v, "hashgrid", "hash-grid"))
        hg.update(viewer_widgets(v, "hashgrid", "hash-grid", trajdir))
        hg["card_vs_cpu"] = viewer_card_vs_cpu(v, "hashgrid", "hash-grid")
    finally:
        v.close()
    out["hashgrid"] = hg
    points_file = v.points_path

    # 2. the MLP field's viewer on the phase-5 workspace, --background
    # white for the crop check
    scene = os.path.join(work, "scene")
    mlp = [scene, "--field_type", "mlp", "--data_type", "llff",
           "--workspace", os.path.join(work, "train_ws")]
    v = Viewer(mlp + ["--test", "--gui", "--background", "white"])
    try:
        assert v.trainer.resumed and v.sess.scene is None
        print(f"[viewer] the MLP field's viewer (phase-5 workspace, "
              f"--background white): serving {v.base}", flush=True)
        ml = {"frames": viewer_frames(v, "mlp", "MLP")}
        ml.update(viewer_picks(v, "mlp", "MLP"))
        ml.update(viewer_widgets(v, "mlp", "MLP", os.path.join(
            work, "viewer_mlp_trajectories")))
        ml["crop_empties"] = viewer_crop_empties(v, "MLP")
        ml["card_vs_cpu"] = viewer_card_vs_cpu(v, "mlp", "MLP")
    finally:
        v.close()
    out["mlp"] = ml

    # 3. the decode of the viewer's picked points: scripts/decode.sh with
    # --point_file set to them, over phase 12's feature cache
    dec = script_argv("decode.sh", env) + ["--downscale", str(SCRIPTS_DS)]
    dec[dec.index("--point_file") + 1] = points_file
    t, dt, launches = run_cli(dec)
    n_views = 17
    check_counts("[viewer] decode.sh --point_file <the viewer's picks>",
                 launches, {"K10": n_views * frame_counts(
                     "hashgrid", VIEW * VIEW)["K10"]})
    obj = os.path.join(t.cfg.workspace, "object_masks")
    with open(os.path.join(obj, "valid_dict.json")) as f:
        valid = json.load(f)
    assert sorted(valid) == [f"v{i:02d}" for i in range(n_views)], valid
    for stem in valid:
        m = np.load(os.path.join(obj, f"{stem}_obj_mask.npy"))
        assert m.shape == (1, VIEW, VIEW) and m.dtype == np.uint8
    with open(os.path.join(t.cfg.workspace, "log_ngp.txt")) as f:
        gate = [l_.strip() for l_ in f if l_.startswith("[decode] v")]
    gate = gate[-n_views:]  # this run's: the log is appended to
    assert [g.split()[1] for g in gate] == sorted(valid), gate
    # a view is valid when every picked point passes its depth gate
    # (valid_threshold -1: int(0.8 * 3) + 1 points); on a 20-step field the
    # rendered depth is a diffuse mean, so few or none may pass
    n_valid = int(sum(valid.values()))
    print(f"[viewer] decode of the 3 picked points: {n_views} views in "
          f"{dt:.2f} s ({dt / n_views:.3f} s a view), valid "
          f"{n_valid}/{n_views} at depth_tol 0.05; the gate: "
          + "; ".join(gate), flush=True)
    out["decode"] = {"seconds": dt, "valid": n_valid}
    del t

    # 4. training ticks: the gui branch without --test, both fields
    out["ticks"] = {
        "hashgrid": viewer_ticks([a for a in gui if a != "--test"],
                                 "hashgrid", "hash-grid"),
        "mlp": viewer_ticks(mlp + ["--gui"], "mlp", "MLP")}

    # 5. trajectories: interp and circle on the MLP field at 512x512, the
    # viewer's saved keyframes on the hash-grid field at 1024x1024 (with
    # --vis_pose)
    out["trajectories"] = {}
    for kind_ in ("interp", "circle"):
        flags = (["--render_trajectory"] if kind_ == "interp"
                 else ["--circle"])
        n = TRAJ_FRAMES[kind_]
        out["trajectories"][kind_] = trajectory_run(
            mlp + ["--test"] + flags, "mlp", f"MLP --test {flags[0]}", n,
            [f"traj_{i:04d}" for i in range(n)], VIEW, VIEW)
    replay = gui + ["--trajectory_root", trajdir, "--vis_pose"]
    out["trajectories"]["replay"] = trajectory_run(
        replay, "hashgrid", "hash-grid --test --trajectory_root",
        REPLAY_FRAMES, [f"0000_{i:04d}" for i in range(REPLAY_FRAMES)],
        REPLAY_RES, REPLAY_RES)

    # 6. --vis_pose (that run): 9 segments a camera, the two boxes (bound
    # 128), the sparse points
    s = load_scene(env["SANERFHQ_DATA_PATH"], "mip", SCRIPTS_DS,
                   enable_cam_center=True, load_images=False)
    ply = os.path.join(env["SANERFHQ_WORKSPACE_ROOT"], "rgb_nerf", "sphere",
                       "poses.ply")
    with open(ply) as f:
        head = [next(f).strip() for _ in range(12)]
    segs = 9 * s.poses.shape[0] + 12 + 12
    assert head[2] == f"element vertex {2 * segs + s.pts3d.shape[0]}", head
    assert head[9] == f"element edge {segs}", head
    print(f"[viewer] --vis_pose: {ply}: {segs} segments ({s.poses.shape[0]} "
          f"cameras, two boxes), {s.pts3d.shape[0]} sparse points",
          flush=True)
    out["vis_pose"] = {"segments": segs, "points": int(s.pts3d.shape[0])}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[viewer] phase 14 in {out['seconds']:.2f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: data parallelism, LPIPS and the native COLMAP reader
# ---------------------------------------------------------------------------

SHARD_NS = (3128, 1001)  # a stage-3 batch's shard at world size 2, odd N
DP_STEPS = 20  # steps of each run under torchrun
DP_RAY_PAIR_ITER = 10  # (b): the ray-pair loss on past step 10, cut from 150
DP_RANK_STEPS = 10  # (b): sharded steps with the ranks' batches compared
# two trainings of the same flags are held to JAX's rule for its 1-vs-8
# device test: a sharding fault moves most elements, while fp32 sums in
# another order (the ranks' partial sums) move a few
# by an lr-sized Adam step (eps 1e-15).  So the share of elements apart by
# more than 1e-3 (JAX's 1%) and the mean abs difference are held; the max
# abs, one element's step, is printed
DP_SHARE, DP_MEAN = 1e-2, 1e-3


def check_shard_sizes(field):
    """Phase 15: the level kernels K5, K1, K2, K3, K4 and K10 at ray counts
    that a rank's shard gives (not multiples of 128 or 256), each against
    its plain twin at the phase-3 bars."""
    dev = field.cp_x.device
    ro_all, rd_all = view_rays(dev, 64, 128)
    g = torch.Generator(dev).manual_seed(5)
    pargs = dict(freq_degree=field.prop_freq_degree,
                 grid_bound=field.grid_bound, opaque_last=True,
                 density_bias=field.density_bias)
    worst = {}
    for N in SHARD_NS:
        ro, rd = ro_all[:N].contiguous(), rd_all[:N].contiguous()
        sn, sf = s_space(ro, rd)
        s_bins = torch.linspace(0.0, 1.0, 129, device=dev).expand(N, 129)
        s_bins = s_bins.contiguous()
        errs = {}
        for level, (T, Q) in enumerate(((128, 65), (64, 33))):
            real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
            u = stratified_queries(N, Q, dev).contiguous()
            ws = (field.prop_mlp_0 if level == 0 else field.prop_mlp_1).weights
            call = (ro, rd, real, s_bins, u, ws)
            nb5 = rl.fused_prop_level_sample(*call, **pargs)
            errs[f"K5 T{T} bins"] = (
                nb5 - rl.prop_level_sample_ref(*call, **pargs)).abs().max()
            w, nb = rl.fused_prop_level_sample_train(*call, **pargs)
            w_ref, nb_ref = rl.prop_level_train_sample_ref(*call, **pargs)
            errs[f"K1 T{T} bins"] = (nb - nb_ref).abs().max()
            errs[f"K1 T{T} weights rel"] = rel_max(w, w_ref)
            g_w = torch.randn(N, T, generator=g, device=dev)
            bcall = (ro, rd, real, ws, g_w)
            for i, (a, b_) in enumerate(zip(
                    rl.fused_prop_level_bwd(*bcall, **pargs),
                    rl.prop_level_bwd_ref(*bcall, **pargs))):
                errs[f"K2 T{T} dW{i} rel"] = rel_max(a, b_)
            s_bins = nb5
        real = spacing_fn_inv(sn * (1.0 - s_bins) + sf * s_bins)
        T = real.shape[1] - 1
        sh = sh_encode(rd / torch.linalg.norm(rd, dim=-1, keepdim=True))
        ws, cps = field.trunk.weights, field.cp_basis
        fargs = dict(freq_degree=field.freq_degree, skip_layer=2,
                     grid_bound=field.grid_bound, opaque_last=True,
                     density_bias=field.density_bias, cps=cps,
                     cp_res=field.cp_res)
        for name, a, b_ in zip(
                ("f_image", "depth", "weights_sum", "weights"),
                rl.fused_final_level(ro, rd, real, sh, ws, **fargs),
                rl.final_level_ref(ro, rd, real, sh, ws, **fargs)):
            errs[f"K3 {name} rel"] = rel_max(a, b_)
        cots = [torch.randn(*shape, generator=g, device=dev)
                for shape in ((N, 31), (N,), (N,), (N, T))]
        call = (ro, rd, real, sh, ws, *cots)
        (dws, dcps), (want_w, want_c) = (
            rl.fused_final_level_bwd(*call, **fargs),
            rl.final_level_bwd_ref(*call, **fargs))
        for i, (a, b_) in enumerate(zip(dws, want_w)):
            errs[f"K4 dW{i} rel"] = rel_max(a, b_)
        for i, (a, b_) in enumerate(zip(dcps, want_c)):
            errs[f"K4 dcp{i} rel"] = rel_max(a, b_)
        for K, Q in ((129, 65), (65, 33)):
            cdf, bins, u = pdf_rows(dev, N, K, Q, seed=K)
            errs[f"K10 K{K} Q{Q}"] = (sample_pdf_lookup(cdf, bins, u)
                                      - sample_pdf_lookup_ref(cdf, bins, u)
                                      ).abs().max()
        torch.cuda.synchronize()
        errs = {k: float(v) for k, v in errs.items()}
        for k, v in errs.items():
            bar = (2e-2 if k.endswith("rel") else
                   1e-6 if k.startswith("K10") else 1e-3)
            assert np.isfinite(v) and v <= bar, (N, k, v, bar)
            worst[k] = max(worst.get(k, 0.0), v)
        print(f"[dp] kernels at a shard of N = {N} rays against their plain "
              "twins: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + " (bins <= 1e-3, rel-max < 2e-2, K10 <= 1e-6)", flush=True)
    return worst


def _mask_draw(trainer, scene, masks_dir, n_views, seed=11):
    """A stage-3 batch drawn as train_mask draws it, on the scripts' scene
    (the held-out views v00 and v16 left out)."""
    cfg, dev = trainer.cfg, trainer.device
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
    gen = torch.Generator(dev).manual_seed(seed)
    # from gen, so that every rank of a process group holds the same map
    em = torch.rand((len(idx), S * S), generator=gen, device=dev) + 0.05

    def draw(m=em):
        return sample_mask_batch(gen, masks_t, poses_t, intr_t, m,
                                 cfg.num_rays, cfg.num_local_sample,
                                 cfg.local_sample_patch_size, res, res, S)

    return draw, gen, em


def _rates(steps):
    """{name: steps/s} of step functions timed in turns (a, b, b, a): the
    mean of each name's two runs."""
    order = list(steps) + list(steps)[::-1]
    got = {k: [] for k in steps}
    for k in order:
        got[k].append(steps_per_s(steps[k]))
    return {k: float(np.mean(v)) for k, v in got.items()}


def dp_worker(spec_path):
    """Phase 15's process under `python -m torch.distributed.run`: each run
    of the spec through cli.main (the counts set to 0 just before and read
    just after), then, on the trained field, one step of the sharded step
    against the unsharded step on one batch (grads after the all-reduce)
    and the step rates with and without the process group; rank 0 writes
    the results as JSON."""
    import torch.distributed as dist

    from sanerf_hq_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    out = {}
    for run in spec["runs"]:
        trainer, dt, launches = run_cli(run["argv"])
        assert pm.is_distributed(), "cli.main did not join the process group"
        res = {"launches": launches, "seconds": dt,
               "step": trainer.state.step, "world": pm.world_size(),
               "backend": dist.get_backend(),
               "device": str(trainer.device)}
        if run["kind"] == "rgb":
            res.update(dp_worker_rgb(trainer, run))
        else:
            res.update(dp_worker_mask(trainer, run))
        out[run["tag"]] = res
    if pm.is_main_process():
        with open(spec["out"], "w") as f:
            json.dump(out, f)
    pm.barrier()
    dist.destroy_process_group()
    return 0


def dp_worker_rgb(trainer, run):
    """(a) in the worker: the eval images against render_view, the
    sharded step against the unsharded one on one batch, the rates."""
    scene, dev = run["scene"], trainer.device
    s = load_scene(scene, "llff")
    val = split_indices(s.poses.shape[0], "val")
    images_equal = True
    for i in val:
        stem = os.path.splitext(str(s.img_names[i]))[0]
        png = read_png(os.path.join(trainer.workspace, "validation",
                                    f"{stem}_rgb.png"))
        img = trainer.render_view(s.poses[i], s.intrinsics[i], s.H,
                                  s.W)["image"].reshape(s.H, s.W, 3)
        images_equal &= bool(np.array_equal(
            png, (np.clip(img, 0, 1) * 255).astype(np.uint8)))
    assert images_equal, "the eval images differ from render_view's"

    # one step from the trained state: the sharded loss (this rank's rows,
    # the grads all-reduced) against the unsharded loss, the same draws
    from sanerf_hq_tpu_torch.parallel.mesh import allreduce_grads
    cfg, model = trainer.cfg, trainer.model
    scene_t = train_tensors(scene, dev)
    plain = make_rgb_train_step(model, cfg)
    grads = {}
    for kind, fn in (("sharded", trainer.train_step), ("plain", plain)):
        gen = torch.Generator(dev).manual_seed(3)
        batch = sample_rgb_batch(gen, *scene_t, cfg.num_rays,
                                 random_image_batch=cfg.random_image_batch)
        model.zero_grad(set_to_none=True)
        loss, _ = fn.loss_fn(batch, trainer.state.step, True, gen)
        loss.backward()
        if kind == "sharded":
            allreduce_grads(list(model.parameters()))
        grads[kind] = {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}
    model.zero_grad(set_to_none=True)
    bitwise = {n: bool(torch.equal(g, grads["plain"][n]))
               for n, g in grads["sharded"].items()}
    cp_diff = max(float((g - grads["plain"][n]).abs().max())
                  for n, g in grads["sharded"].items() if n.startswith("cp_"))
    not_cp = [n for n in bitwise if not n.startswith("cp_")]
    # at one rank the same sums; at more the rays' sums split over ranks
    grad_rel = max(rel_max(grads["sharded"][n], grads["plain"][n])
                   for n in not_cp)
    if pm_world() == 1:
        assert all(bitwise[n] for n in not_cp), bitwise
    else:
        assert grad_rel <= 1e-4, grad_rel

    state = trainer.state
    gen = torch.Generator(dev).manual_seed(1)

    def stepper(fn):
        return lambda: fn(state, sample_rgb_batch(
            gen, *scene_t, cfg.num_rays,
            random_image_batch=cfg.random_image_batch), gen)

    rates = _rates({"no_pg": stepper(plain),
                    "pg": stepper(trainer.train_step)})
    return {"images_equal": images_equal, "grads_bitwise": bitwise,
            "cp_grads_max_abs_diff": cp_diff,
            "non_cp_grads_rel_max": grad_rel, "rates": rates,
            "losses": trainer.stats["loss"]}


def pm_world():
    from sanerf_hq_tpu_torch.parallel.mesh import world_size
    return world_size()


def dp_worker_mask(trainer, run):
    """(b) in the worker: one mask step's loss and grads, sharded (the
    grads all-reduced) against unsharded on one batch; the error map's
    update on the card against a sequential write; DP_RANK_STEPS steps of
    the sharded step, each drawing its batch from the map the last one
    left, with every rank's batch and map held bitwise to rank 0's; the
    step rates with and without the process group, and the loss trace."""
    from sanerf_hq_tpu_torch.parallel.mesh import allreduce_grads
    from sanerf_hq_tpu_torch.train.steps import write_cells

    draw, gen, em = _mask_draw(trainer, run["scene"], run["masks"], 17)
    cfg, model = trainer.cfg, trainer.model
    steps = {k: make_mask_train_step(model, cfg, frozen_backbone=True,
                                     shard=sh)
             for k, sh in (("no_pg", None), ("pg", trainer.shard))}
    batch = draw()
    one = {}
    for kind, fn in steps.items():
        g = torch.Generator(trainer.device).manual_seed(4)
        model.zero_grad(set_to_none=True)
        loss, metrics, _ = fn.loss_fn(batch, trainer.state.step, em, g)
        loss.backward()
        if kind == "pg":
            allreduce_grads(list(model.parameters()))
        one[kind] = ({k: float(v.detach()) for k, v in metrics.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    model.zero_grad(set_to_none=True)
    (m_pg, g_pg), (m_plain, g_plain) = one["pg"], one["no_pg"]
    not_grid = [n for n in g_plain if n != "m_grid"]
    grid_rel = rel_max(g_pg["m_grid"], g_plain["m_grid"])
    grads_rel = max(rel_max(g_pg[n], g_plain[n]) for n in not_grid)
    metrics_rel = max(abs(m_pg[k] - v) / max(abs(v), 1e-12)
                      for k, v in m_plain.items())
    if pm_world() == 1:
        assert m_pg == m_plain, (m_pg, m_plain)
        assert grads_rel == 0.0, not_grid
    else:
        # a shard's products differ from the whole batch's in their last
        # bits (ce 8e-5 rel at 4 ranks), and the grads' sums split over
        # ranks; a misplaced row moves them by O(1): the kernels' bar
        assert metrics_rel <= 1e-3 and grads_rel <= 2e-2, (
            m_pg, m_plain, grads_rel)
    assert grid_rel <= 2e-2, grid_rel  # index_add_'s fp32 atomics

    # the map's update on the card: a cell drawn twice takes the last
    # draw's value, as a sequential write on the host gives it
    views, cells = batch["img_inds"], batch["inds_coarse"]
    flat = (views * em.shape[1] + cells).cpu()
    repeats = int(flat.numel() - flat.unique().numel())
    vals = torch.rand(flat.shape, generator=torch.Generator().manual_seed(5))
    want = em.cpu().reshape(-1).clone()
    for k, v in zip(flat.tolist(), vals.tolist()):
        want[k] = v
    got = write_cells(em, views, cells, vals.to(em.device))
    assert repeats > 0 and torch.equal(got.cpu().reshape(-1), want), repeats

    # the sharded steps from the drawn map: every rank the same batches
    # and maps (the ranks compute the loss, and so the map, alike)
    agree, m = True, em.clone()
    for _ in range(DP_RANK_STEPS):
        b = draw(m)
        _, m = steps["pg"](trainer.state, b, gen, m)
        for t in (b["img_inds"], b["inds_coarse"], b["rays_o"],
                  b["gt_masks"], m):
            agree &= _same_on_every_rank(t)
    assert agree, "the ranks' error maps or batches differ"

    def stepper(fn):
        return lambda: fn(trainer.state, draw(), gen, em)[0]

    rates = _rates({k: stepper(fn) for k, fn in steps.items()})
    return {"rates": rates, "trace": trainer.stats["mask"],
            "one_step_metrics": m_pg, "one_step_metrics_rel": metrics_rel,
            "one_step_grads_rel": grads_rel, "m_grid_grad_rel": grid_rel,
            "m_grid_grad_max_abs_diff": float(
                (g_pg["m_grid"] - g_plain["m_grid"]).abs().max()),
            "map_repeats": repeats, "ranks_agree": agree,
            "rank_steps": DP_RANK_STEPS}


def miou(text):
    """The last [EVAL] MeanIoU of a CLI log."""
    return float(text.split("[EVAL] MeanIoU = ")[-1].split()[0])


def _trace_gap(trace, ref):
    """The largest gap of ce, loss and acc between two stage-3 loss
    traces logged at the same steps."""
    assert [s_ for s_, _ in trace] == [s_ for s_, _ in ref], (trace, ref)
    return max(abs(v[k] - w[k]) for (_, v), (_, w) in zip(trace, ref)
               for k in ("ce", "loss", "acc"))


def mask_checks_line(b):
    """What dp_worker_mask checked, for the log."""
    return (f"one step sharded (all-reduced) against unsharded on one "
            f"batch: metrics rel {b['one_step_metrics_rel']:.3e}, the mask "
            f"MLP's grads rel {b['one_step_grads_rel']:.3e}, m_grid's grads "
            f"rel {b['m_grid_grad_rel']:.3e} (max abs "
            f"{b['m_grid_grad_max_abs_diff']:.3e}; index_add_'s atomics); "
            f"the error map's update on the card equal to a sequential "
            f"write ({b['map_repeats']} cells drawn twice); "
            f"{b['rank_steps']} sharded steps with every rank's batch and "
            f"error map bitwise rank 0's {b['ranks_agree']}")


def _same_on_every_rank(t):
    """Whether t is bitwise rank 0's t on every rank (all-gathered)."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)


def mask_run(root, ws):
    """The --dp-worker spec of (b): the scripts' stage 3 over the tree
    under root."""
    env = scripts_env(root)
    return {"tag": "b", "kind": "mask", "scene": env["SANERFHQ_DATA_PATH"],
            "masks": env["SANERFHQ_MASK_PATH"], "argv": obj_argv(root, ws)}


def _param_diff(a, b):
    """(all bitwise equal, worst max abs, worst mean abs, worst share of
    elements apart by more than 1e-3) over two state_dicts."""
    worst = [True, 0.0, 0.0, 0.0]
    for name, x in a.items():
        d = (x.double() - b[name].double()).abs()
        worst[0] &= bool(torch.equal(x, b[name]))
        if d.numel():
            worst[1] = max(worst[1], float(d.max()))
            worst[2] = max(worst[2], float(d.mean()))
            worst[3] = max(worst[3], float((d > 1e-3).double().mean()))
    return worst


def _same_training(diff):
    return diff[3] < DP_SHARE and diff[2] < DP_MEAN


def _eval_metrics(log):
    """The last [EVAL] PSNR, SSIM and LPIPS values of a CLI log."""
    return {k: float(log.split(f"[EVAL] {k}")[-1].split("= ")[1].split()[0])
            for k in ("PSNR", "SSIM", "LPIPS")}


def rgb_argv(scene, ws):
    """Phase 5's stage-1 flags (the MLP field, 20 steps of 8192 rays, one
    eval and one checkpoint) in workspace ws."""
    return [scene, "--field_type", "mlp", "--data_type", "llff",
            "--workspace", ws, "--seed", "0", "--iters", str(DP_STEPS),
            "--eval_cnt", "1", "--save_cnt", "1"]


def load_ckpt(ws):
    """The model and EMA tensors of the workspace's step-DP_STEPS
    checkpoint, prefixed."""
    st = torch.load(os.path.join(ws, "checkpoints", f"step_{DP_STEPS:08d}.pt"),
                    map_location="cpu", weights_only=True)
    return {**{f"model.{k}": v for k, v in st["model"].items()},
            **{f"ema.{k}": v for k, v in st["ema"].items()}}


def torchrun(work, nproc, runs, tag):
    """One `python -m torch.distributed.run --standalone` of this script's
    --dp-worker over `runs` at nproc ranks: (rank 0's results, its
    stdout, seconds).  A failing rank fails it."""
    spec = os.path.join(work, f"dp_spec_{tag}.json")
    result = os.path.join(work, f"dp_result_{tag}.json")
    with open(spec, "w") as f:
        json.dump({"runs": runs, "out": result}, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__),
           "--dp-worker", spec]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    dt = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        if line.startswith(("[EVAL]", "[INFO] training took",
                            "[INFO] mask training", "[INFO] sharding",
                            "[mask ")):
            print(f"[dp] {tag} rank 0: {line}", flush=True)
    assert r.returncode == 0, (r.returncode, r.stdout[-3000:],
                               r.stderr[-6000:])
    with open(result) as f:
        return json.load(f), r.stdout, dt


def dp_world(work, scene, nproc, w1_state, w1_eval, spread, root=None,
             w1_mask=None):
    """(a) at world size nproc (NCCL, one rank a card) against world size
    1: the parameters (_same_training), the eval's PSNR, SSIM and LPIPS
    within 1e-4 rel, one step's non-CP grads within 1e-4 rel of the
    unsharded step's, the launches, the rates with and without the
    process group (without: each rank trains the whole batch alone).
    With root (the scripts' tree), (b) too: dp_worker_mask's checks at
    nproc ranks, and the loss trace against w1_mask's (world size 1)."""
    ws = os.path.join(work, f"dp_rgb_w{nproc}")
    runs = [{"tag": "a", "kind": "rgb", "scene": scene,
             "argv": rgb_argv(scene, ws)}]
    if root is not None:
        runs.append(mask_run(root, os.path.join(work, f"dp_obj_w{nproc}")))
    res, log, dt = torchrun(work, nproc, runs, f"w{nproc}")
    a = res["a"]
    d = _param_diff(load_ckpt(ws), w1_state)
    ev = _eval_metrics(log)
    print(f"[dp] (a) world size {a['world']} against world size 1: max abs "
          f"{d[1]:.3e}, mean {d[2]:.3e}, share > 1e-3 {d[3]:.3e} (runs "
          f"without torchrun apart by {spread[1]:.3e}, {spread[2]:.3e}, "
          f"{spread[3]:.3e}); the eval {ev} against {w1_eval}; one step's "
          f"non-CP grads rel-max "
          f"{a['non_cp_grads_rel_max']:.3e}; launches on rank 0 "
          f"{a['launches']}; steps/s of {BATCH} rays, each rank alone / "
          f"sharded over {nproc}: {a['rates']['no_pg']:.3f} / "
          f"{a['rates']['pg']:.3f}; {dt:.2f} s ({device_line()})",
          flush=True)
    assert a["world"] == nproc and _same_training(d), (d, spread)
    # rel 1e-4, or two units of the 6 printed decimals
    assert all(abs(ev[k] - w1_eval[k]) <= max(1e-4 * abs(w1_eval[k]), 2e-6)
               for k in ev), (ev, w1_eval)
    out = {"world": nproc, "vs_world1": d, "eval": ev, "rates": a["rates"],
           "launches": a["launches"],
           "non_cp_grads_rel_max": a["non_cp_grads_rel_max"]}
    if root is None:
        return out
    b = res["b"]
    trace = [(s_, v) for s_, v in b["trace"]]
    gap = 0.0 if w1_mask is None else _trace_gap(trace, w1_mask["trace"])
    print(f"[dp] (b) world size {b['world']}: {mask_checks_line(b)}; the "
          f"loss trace {trace}, its largest gap of ce, loss and acc to world "
          f"size 1's {gap:.3e}; MeanIoU "
          f"{miou(log):.6f}; launches on rank 0 {b['launches']}; steps/s, "
          f"each rank alone / sharded over {nproc}: "
          f"{b['rates']['no_pg']:.3f} / {b['rates']['pg']:.3f}", flush=True)
    assert b["world"] == nproc and b["ranks_agree"], b
    assert all(b["launches"][k] == 0 for k in LEVEL_KERNELS + ("K8",))
    assert b["launches"]["K10"] >= 2 * DP_STEPS, b["launches"]
    out["b"] = {k: b[k] for k in (
        "launches", "rates", "one_step_metrics_rel", "one_step_grads_rel",
        "m_grid_grad_rel", "map_repeats", "ranks_agree")}
    out["b"].update(trace=trace, trace_gap=gap, miou=miou(log))
    return out


def dp_cards():
    """`--dp-cards`: phase 15's (a) and (b) across every card of the host:
    world size N against world size 1, and (a) against two runs without
    torchrun, on phase 4's scene and on the scripts' tree (a COLMAP scene
    at a quarter of phase 11's size and a hash-grid stage 1 of
    SCRIPTS_S1_STEPS steps)."""
    cards = torch.cuda.device_count()
    dev_line = device_line()
    print(f"{dev_line} x {cards}", flush=True)
    cuda_lib.build_all()  # once here, not in every rank
    work = os.path.join(ROOT, "build", "chip_smoke_cards")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    scene = os.path.join(work, "scene")
    write_llff_scene(scene, n_views=17, H=VIEW, W=VIEW)
    root = os.path.join(work, "scripts")
    write_scripts_scene(root, VIEW // 4)
    run_cli(script_argv("train_rgb_nerf.sh", scripts_env(root))
            + ["--iters", str(SCRIPTS_S1_STEPS)])
    for tag in ("ref1", "ref2"):
        run_cli(rgb_argv(scene, os.path.join(work, f"dp_rgb_{tag}")))
    ref1, ref2 = (load_ckpt(os.path.join(work, f"dp_rgb_{t}"))
                  for t in ("ref1", "ref2"))
    spread = _param_diff(ref2, ref1)
    ref_eval = _eval_metrics(open(os.path.join(
        work, "dp_rgb_ref1", "log_ngp.txt")).read())
    w1 = dp_world(work, scene, 1, ref1, ref_eval, spread, root)
    out = {"cards": cards, "spread_without": spread, "w1": w1}
    if cards > 1:
        out[f"w{cards}"] = dp_world(work, scene, cards, load_ckpt(
            os.path.join(work, "dp_rgb_w1")), w1["eval"], spread, root,
            w1["b"])
    print(json.dumps({"dp_cards": out}), flush=True)
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}))
    return 0


def dp_path(work):
    """Phase 15: (a) stage 1 of the MLP field and (b) the scripts' stage 3
    through the CLI under torch.distributed.run (NCCL, one rank a card),
    each against the same CLI run without it; (c) LPIPS on the card
    against the CPU; (d) the native COLMAP reader; (e) rates and launch
    counts; and the kernels at shard sizes (check_shard_sizes, run from
    main beside phase 3)."""
    cards = torch.cuda.device_count()
    scene = os.path.join(work, "scene")
    root = os.path.join(work, "scripts")
    env = scripts_env(root)
    runs = [{"tag": "a", "kind": "rgb", "scene": scene,
             "argv": rgb_argv(scene, os.path.join(work, "dp_rgb"))},
            mask_run(root, os.path.join(work, "dp_obj"))]
    res, log, dt = torchrun(work, 1, runs, "w1")
    a, b = res["a"], res["b"]
    out = {"torchrun_seconds": dt, "world": a["world"],
           "backend": a["backend"]}
    assert a["world"] == b["world"] == 1 and a["backend"] == "nccl", res
    for metric in ("[EVAL] PSNR", "[EVAL] SSIM", "[EVAL] LPIPS"):
        assert metric in log, f"{metric} missing from the stage-1 eval"
    print(f"[dp] torch.distributed.run --nproc_per_node 1 ({a['backend']}, "
          f"world size {a['world']}, {a['device']}): (a) and (b) in "
          f"{dt:.2f} s, the process's start included", flush=True)

    # (a) against the CLI without torchrun: phase 5's run of the same
    # flags, and a second run now (bitwise where the two agree bit for
    # bit, as they do with K4's CP grads summed in a fixed order)
    ref2, _, _ = run_cli(rgb_argv(scene, os.path.join(work, "dp_rgb_ref2")))
    dp_state, ref, ref_b = (load_ckpt(os.path.join(work, w)) for w in
                            ("dp_rgb", "train_ws", "dp_rgb_ref2"))
    d_dp, d_ref = _param_diff(dp_state, ref), _param_diff(ref_b, ref)
    print(f"[dp] (a) stage 1, {DP_STEPS} steps of {BATCH} rays under "
          f"torchrun against phase 5's run without it: bitwise equal "
          f"{d_dp[0]}, max abs {d_dp[1]:.3e}, mean {d_dp[2]:.3e}, share > "
          f"1e-3 {d_dp[3]:.3e}; two runs without it: bitwise equal "
          f"{d_ref[0]}, max abs {d_ref[1]:.3e}, mean {d_ref[2]:.3e}; one "
          f"step's grads, sharded (all-reduced) against unsharded: every "
          f"non-CP grad bitwise equal, CP grads max abs "
          f"{a['cp_grads_max_abs_diff']:.3e}; the eval "
          f"images equal render_view's {a['images_equal']}; where the runs "
          f"without it differ, the share apart by > 1e-3 held under "
          f"{DP_SHARE:g} and the mean under {DP_MEAN:g} (Adam's eps 1e-15 "
          "lifts a last-bit difference to an lr-sized step on single "
          "elements)", flush=True)
    if d_ref[0]:
        assert d_dp[0], "torchrun at world size 1 moved the parameters"
    else:
        assert _same_training(d_dp), (d_dp, d_ref)
    assert ref2.state.step == DP_STEPS
    views = 4  # the in-loop eval at the last epoch and the CLI's final one
    chunks = views * -(-VIEW * VIEW // CHUNK)
    want = {"K1": 2 * DP_STEPS, "K2": 2 * DP_STEPS,
            "K3": DP_STEPS + chunks, "K4": DP_STEPS, "K5": 2 * chunks,
            "K6": 0, "K7": 0, "K8": 0, "K10": 0}
    got = {k: a["launches"][k] for k in want}
    print(f"[dp] (a) launches {got}, reckoned {want} (K1, K2 2 a step, "
          f"K3 1 a step + 16 an eval view, K4 1 a step, K5 32 an eval view, "
          f"{views} eval views of {VIEW}x{VIEW})", flush=True)
    assert got == want, (got, want)
    out["a"] = {"bitwise_equal": d_dp[0], "max_abs": d_dp[1],
                "mean_abs": d_dp[2], "share_above_1e-3": d_dp[3],
                "runs_without_bitwise_equal": d_ref[0],
                "runs_without_max_abs": d_ref[1],
                "cp_grads_max_abs_diff": a["cp_grads_max_abs_diff"],
                "launches": got, "steps_per_s": a["rates"],
                "losses": a["losses"]}

    # (b) against two runs of the same CLI without torchrun: m_grid's
    # grads are summed by index_add_'s fp32 atomics, so past step 1 the
    # runs need not agree bit for bit, and a map apart in its last bits
    # moves a few of the next batch's cells; step 1's losses are held
    # bitwise, the trace's gap printed
    refs = [run_cli(obj_argv(root, os.path.join(work, f"dp_obj_ref{i}")))[0]
            for i in (1, 2)]
    traces = [[(s_, v) for s_, v in b["trace"]]] + [
        [(s_, v) for s_, v in r.stats["mask"]] for r in refs]
    mious = [miou(log)] + [miou(open(os.path.join(
        r.cfg.workspace, "log_ngp.txt")).read()) for r in refs]
    first_equal = all(t[0] == traces[0][0] for t in traces)
    spread = abs(mious[2] - mious[1])
    gaps = [_trace_gap(t, traces[1]) for t in (traces[0], traces[2])]
    print(f"[dp] (b) scripts' stage 3, {DP_STEPS} steps (the ray-pair loss "
          f"on past step {DP_RAY_PAIR_ITER}): {mask_checks_line(b)}; the "
          f"CLI's loss trace under torchrun {traces[0]}, two runs without "
          f"{traces[1]} / {traces[2]}: step 1 bitwise equal {first_equal}, "
          f"the largest gap of ce, loss and acc to the first run without "
          f"{gaps[0]:.3e} (the second run {gaps[1]:.3e}); MeanIoU "
          f"{mious[0]:.6f} against {mious[1]:.6f} / {mious[2]:.6f} (within "
          f"1e-2)", flush=True)
    assert first_equal, traces
    assert abs(mious[0] - mious[1]) <= 1e-2, mious
    ref3 = refs[0]
    n_train = 17 - 2
    em_chunks = (DP_STEPS // DP_RAY_PAIR_ITER) * n_train * -(
        -ref3.cfg.error_map_size ** 2 // CHUNK)
    val_chunks = 2 * -(-VIEW * VIEW // CHUNK)
    want = {k: 0 for k in LEVEL_KERNELS + ("K8",)}
    want["K10"] = 2 * (DP_STEPS + em_chunks + val_chunks)
    got = {k: b["launches"][k] for k in want}
    print(f"[dp] (b) launches {got}, reckoned {want} (K10 2 a step, 2 an "
          f"error-map chunk ({em_chunks}) and an eval chunk ({val_chunks}))",
          flush=True)
    assert got == want, (got, want)
    out["b"] = {"step1_bitwise_equal": first_equal, "mious": mious,
                "miou_spread_without": spread, "trace_gaps": gaps,
                "m_grid_grad_max_abs_diff": b["m_grid_grad_max_abs_diff"],
                "map_repeats": b["map_repeats"],
                "launches": got, "steps_per_s": b["rates"],
                "traces": traces}

    # (c) LPIPS on the card against the CPU on the two eval images of (a)
    params = random_lpips_params()
    fn_card, fn_cpu = (make_lpips_fn(params, d) for d in ("cuda", "cpu"))
    vals = []
    for stem in ("v00", "v16"):
        pred, gt = (read_png(os.path.join(
            work, "dp_rgb", "validation", f"{stem}_{k}.png")).astype(
                np.float32) / 255.0 for k in ("rgb", "gt"))
        card, cpu = float(fn_card(pred, gt)), float(fn_cpu(pred, gt))
        r = abs(card - cpu) / abs(cpu)
        assert r <= 1e-4, (stem, card, cpu)
        vals.append((card, cpu, r))
    p_t, g_t = (torch.as_tensor(x, device="cuda") for x in (pred, gt))
    ms = cuda_ms(lambda: fn_card(p_t, g_t))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn_card(p_t, g_t)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    logged = float(log.split("[EVAL] LPIPS[torch-random-proxy] = ")[-1]
                   .split()[0])
    print(f"[dp] (c) LPIPS (VGG16, the torch-random-proxy weights, TF32 off) "
          f"on the card against the CPU: " + ", ".join(
              f"v{i * 16:02d} {c:.6f} / {p:.6f} (rel {r:.2e})"
              for i, (c, p, r) in enumerate(vals))
          + f" (<= 1e-4; the PNGs, uint8); the CLI's [EVAL] LPIPS "
          f"{logged:.6f} (the float renders); a {VIEW}x"
          f"{VIEW} pair {ms:.4f} ms (CUDA events, median of 10), peak "
          f"device memory {peak:.4f} GiB ({device_line()})", flush=True)
    out["c"] = {"card_vs_cpu_rel": max(r for _, _, r in vals), "ms": ms,
                "peak_memory_gib": peak, "values": vals}

    # (d) the native COLMAP reader on phase 11's COLMAP scene
    sparse = os.path.join(env["SANERFHQ_DATA_PATH"], "sparse", "0")
    t0 = time.perf_counter()
    native = read_model_native(sparse)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = (colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin")),
              colmap.read_images_binary(os.path.join(sparse, "images.bin")),
              colmap.read_points3d_binary(os.path.join(sparse,
                                                       "points3D.bin")))
    t_python = time.perf_counter() - t0
    for part_n, part_p in zip(native, python):
        assert part_n.keys() == part_p.keys()
        for k in part_p:
            for x, y in zip(part_n[k], part_p[k]):
                assert np.array_equal(np.asarray(x), np.asarray(y)), k
    counts = [len(x) for x in native]
    print(f"[dp] (d) the native COLMAP reader on {sparse} ({counts[0]} "
          f"camera, {counts[1]} images, {counts[2]} points): field by field "
          f"equal to the Python reader; {t_native * 1e3:.3f} ms against "
          f"{t_python * 1e3:.3f} ms (host clock, first read)", flush=True)
    out["d"] = {"native_ms": t_native * 1e3, "python_ms": t_python * 1e3,
                "counts": counts}

    # (e) the rates with and without the process group at world size 1
    print(f"[dp] (e) steps/s without / with the process group (world size "
          f"1, the grads' all-reduce and the metrics' mean): (a) "
          f"{a['rates']['no_pg']:.3f} / {a['rates']['pg']:.3f}, (b) "
          f"{b['rates']['no_pg']:.3f} / {b['rates']['pg']:.3f} "
          f"({device_line()})", flush=True)
    if cards >= 2:
        out["a"]["world2"] = dp_world(work, scene, 2, dp_state,
                                      _eval_metrics(log), d_ref)
    else:
        print("[dp] one card: world size 2 against world size 1 rests on "
              "the CPU tests over gloo (tests/test_torch_parallel.py)",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: scripts/bench_rich_scene.sh at the full run lengths
# ---------------------------------------------------------------------------

RICH_ENV = {"ITERS": "5000", "SAM_SIZE": "vit_b"}  # the script's defaults
# floors a field that did not learn cannot pass (the JAX package's records
# on the rich scene, docs/PERF.md: held-out PSNR 28.6, SSIM 0.945, 24 of 24
# views valid, MeanIoU 0.9206)
RICH_GATES = {"PSNR": 26.0, "SSIM": 0.90, "valid": 22, "MeanIoU": 0.85}
RICH_ALL_PSNR = 20.0  # --rich-all: no record to hold these runs to
DEPTH_TOL = 0.05  # the decode's depth gate (stages.decode)
RICH_ORDER = ("stage1", "stage2", "distill", "decode", "stage3",
              "stage3_test")


def script_runs(name, env):
    """Every `python` command of scripts/<name> in order, each as its
    words after `python`, as bash expands them: the script run by bash
    with env's variables (and PATH alone of the caller's), `python` a
    shell function that records its arguments in place of running them.
    So the flag sets follow the script's own defaults, quoting and
    conditionals."""
    rec = os.path.join(ROOT, "build", f"{name}.{os.getpid()}.runs")
    os.makedirs(os.path.dirname(rec), exist_ok=True)
    stub = ('python() { printf "%s\\0" "$#" "$@" >> "$SMOKE_RUNS"; }; '
            'export -f python; exec bash "$0"')
    try:
        subprocess.run(["bash", "-c", stub,
                        os.path.join(ROOT, "scripts", name)],
                       check=True, stdout=subprocess.DEVNULL,
                       stdin=subprocess.DEVNULL,
                       env={"PATH": os.environ["PATH"], "SMOKE_RUNS": rec,
                            **env})
        with open(rec, "rb") as f:
            words = [w.decode() for w in f.read().split(b"\0")[:-1]]
    finally:
        if os.path.exists(rec):
            os.remove(rec)
    runs, i = [], 0
    while i < len(words):
        n = int(words[i])
        runs.append(words[i + 1:i + 1 + n])
        i += n + 1
    return runs


def rich_stage(argv):
    """Which stage of scripts/bench_rich_scene.sh a `main.py` argv is."""
    if "--decode" in argv:
        return "decode"
    if "--with_mask" in argv:
        return "stage3_test" if "--test" in argv else "stage3"
    if "--with_sam" in argv:
        return ("distill" if argv[argv.index("--feature_container") + 1]
                == "distill" else "stage2")
    return "stage1"


def log_text(trainer):
    with open(trainer.log.path) as f:
        return f.read()


def log_rate(text, what):
    """The steps/s of the last "[INFO] {what} took ..." line of a log."""
    return float(re.findall(what + r" took [\d.]+ min \(([\d.]+) steps/s\)",
                            text)[-1])


def rich_expected(stage, field, cfg, n_steps, pv, n_val, n_views, n_train):
    """The launches of one stage of the bench script, reckoned from the
    code: pv chunks a view; stage 1 renders the n_val held-out views
    twice (the in-loop eval at its one eval epoch, then the CLI's PSNR /
    SSIM / LPIPS eval); stage 2 and the decode render every view once
    (the cache's val_all); stage 3 renders an error-map view of each of
    its n_train training views at each rebuild, then the held-out views;
    its --test renders the held-out views.  The MLP field renders through
    the level kernels (K5 twice and K3, or over a frozen backbone K6, once
    a chunk; K1 twice, K2 twice while the proposals update, K3 and K4
    once a training step), the hash-grid field through the composable
    route (K10 twice a step and a chunk)."""
    if stage == "stage1":
        if field != "mlp":
            return {"K10": 2 * n_steps + 4 * n_val * pv}
        upd = sum(update_proposal_at(s_) for s_ in range(n_steps))
        return {"K1": 2 * n_steps, "K2": 2 * upd, "K4": n_steps,
                "K3": n_steps + 2 * n_val * pv, "K5": 4 * n_val * pv}
    if stage in ("stage2", "decode"):
        chunks, k = n_views * pv, "K3"
    elif stage == "stage3":
        chunks = n_steps + rebuild_chunks(cfg, n_train) + n_val * pv
        k = "K6"
    else:
        chunks, k = n_val * pv, "K6"
    if field != "mlp":
        return {"K10": 2 * chunks}
    return {k: chunks, "K5": 2 * chunks}


def rich_stage1(tag, trainer, argv, text, s, train, val):
    """Stage 1's numbers: rate, losses, train and held-out quality."""
    cfg, n = trainer.cfg, trainer.state.step
    losses = trainer.stats["loss"]
    q = _eval_metrics(text)
    rate = log_rate(text, "training")
    last = float(re.findall(r"train_psnr=([\d.]+)", text)[-1])
    # the training views rendered with the EMA weights, as the held-out
    # ones are (after the counted run)
    sc = load_scene(cfg.path, cfg.data_type)
    meter = M.PSNRMeter()
    for i in train:
        img = trainer.render_view(sc.poses[i], sc.intrinsics[i], sc.H,
                                  sc.W)["image"]
        meter.update(img.reshape(sc.H, sc.W, 3), sc.images[i][..., :3])
    finite = bool(losses) and bool(np.isfinite(losses).all())
    print(f"{tag} stage1: {n} steps of {cfg.num_rays} rays (the script's "
          f"--num_rays {argv[argv.index('--num_rays') + 1]} set to "
          f"num_points / the final level's samples, as in JAX), "
          f"{rate:.1f} steps/s; losses finite {finite} (first "
          f"{losses[0]:.5f}, last {losses[-1]:.5f}); train PSNR {last:.2f} "
          f"(last batch), {meter.measure():.4f} (the {len(train)} training "
          f"views); held-out ({len(val)} views) PSNR {q['PSNR']:.4f}, SSIM "
          f"{q['SSIM']:.4f}, LPIPS {q['LPIPS']:.4f} (the random-VGG proxy, "
          f"not gated)", flush=True)
    return finite, {"PSNR": q["PSNR"], "SSIM": q["SSIM"],
                    "LPIPS": q["LPIPS"], "train_psnr_last_batch": last,
                    "train_psnr_views": meter.measure(),
                    "stage1_steps_per_s": rate, "rays": cfg.num_rays,
                    "n_train": len(train), "n_val": len(val)}


def rich_decode(tag, cfg, text):
    """The decode's valid views and each view's depth-gate residuals."""
    with open(os.path.join(cfg.workspace, "object_masks",
                           "valid_dict.json")) as f:
        valid = json.load(f)
    gate = {stem: [float(a) if a else None, float(b) if b else None]
            for stem, a, b in re.findall(
                r"\[decode\] (\S+) valid=\w+(?: gate\|z-depth\| "
                r"min=([\d.]+) max=([\d.]+))?", text)}
    n_valid = sum(valid.values())
    print(f"{tag} decode: valid {n_valid}/{len(valid)} at depth_tol "
          f"{DEPTH_TOL}; the gate's |z - depth| (min, max) by view: "
          + ", ".join(f"{k} {'valid' if valid[k] else 'INVALID'} "
                      + (f"({a:.3f}, {b:.3f})" if a is not None
                         else "(no point in the frame)")
                      for k, (a, b) in gate.items()), flush=True)
    return {"valid": n_valid, "views": len(valid), "gate": gate}


def rich_chain(work, field="mlp", kind="rich", distill_iters=None,
               gates=RICH_GATES):
    """One run of scripts/bench_rich_scene.sh with FIELD=field KIND=kind
    (and DISTILL_ITERS) at the script's full run lengths: its command
    lines, read out of it by bash, the scene writer's through the port's
    tools.make_synth_scene and every `main.py` line through cli.main on
    the card, the launch counts set to 0 just before each and read just
    after; each stage's wall time, rates, quality numbers and launches
    printed, the launches held to rich_expected (the distill line's
    printed).  `gates`: the floors to hold; None holds --rich-all's
    (finite losses, held-out PSNR >= RICH_ALL_PSNR)."""
    scene = os.path.join(work, f"{kind}_llff")
    env = {**RICH_ENV, "KIND": kind, "SCENE": scene, "FIELD": field,
           "WS": os.path.join(work, f"{kind}_ws")}
    if distill_iters:
        env["DISTILL_ITERS"] = str(distill_iters)
    tag = f"[rich {field} {kind}]"
    out = {"field": field, "kind": kind, "seconds": {}, "launches": {}}
    stages_run, finite = [], True
    t_chain = time.perf_counter()
    for words in script_runs("bench_rich_scene.sh", env):
        if words[0] == "scripts/make_synth_scene.py":
            t0 = time.perf_counter()
            names = make_synth_scene.main(words[1:])
            out["seconds"]["scene"] = time.perf_counter() - t0
            print(f"{tag} scene: python -m sanerf_hq_tpu_torch.tools."
                  f"make_synth_scene {' '.join(words[1:])}: {len(names)} "
                  f"views in {out['seconds']['scene']:.2f} s", flush=True)
            continue
        assert words[0] == "main.py", words
        argv, stage = words[1:], rich_stage(words[1:])
        stages_run.append(stage)
        print(f"{tag} {stage}: python -m sanerf_hq_tpu_torch "
              f"{' '.join(argv)}", flush=True)
        trainer, dt, launches = run_cli(argv)
        cfg, text = trainer.cfg, log_text(trainer)
        out["seconds"][stage] = dt
        out["launches"][stage] = launches
        s = load_scene(cfg.path, cfg.data_type, load_images=False)
        test_views = None
        if cfg.test_view_path:
            with open(cfg.test_view_path) as f:
                test_views = json.load(f)["test_view_list"]
        V = s.poses.shape[0]
        train = split_indices(V, "train", cfg.val_type, test_views,
                              s.img_names)
        val = split_indices(V, "val", cfg.val_type, test_views, s.img_names)
        pv = -(-s.H * s.W // CHUNK)
        n_steps, n_train = 0, 0
        if stage == "stage1":
            n_steps = trainer.state.step
            assert n_steps == int(env["ITERS"]), n_steps
            ok, res = rich_stage1(tag, trainer, argv, text, s, train, val)
            finite &= ok
            out.update(res)
        elif stage == "stage2":
            assert len(os.listdir(os.path.join(cfg.workspace,
                                               "sam_cache"))) == V
            print(f"{tag} stage2: {V} views rendered and encoded "
                  f"({cfg.sam_model_type}, 1024^2 input), "
                  f"{dt / V:.3f} s a view", flush=True)
        elif stage == "distill":
            vals = [v["loss"] for _, v in trainer.stats["distill"]]
            finite &= bool(np.isfinite(vals).all())
            mse = float(text.split("[EVAL stage-2] ")[-1].split("= ")[1]
                        .split()[0])
            rate = log_rate(text, "distill training")
            out.update(distill_mse=mse, distill_steps_per_s=rate,
                       distill_loss=[vals[0], vals[-1]])
            print(f"{tag} distill: {trainer.state.step} steps, {rate:.1f} "
                  f"steps/s, loss {vals[0]:.5f} -> {vals[-1]:.5f}; "
                  f"rendered-feature MSE {mse:.6f}", flush=True)
        elif stage == "decode":
            out.update(rich_decode(tag, cfg, text))
        elif stage == "stage3":
            n_steps = trainer.state.step
            vals = [v["loss"] for _, v in trainer.stats["mask"]]
            finite &= bool(np.isfinite(vals).all())
            rate = log_rate(text, "mask training")
            _, valid_idx = load_object_masks(cfg.mask_root, s.img_names,
                                             s.H, s.W, seed=cfg.seed)
            n_train = int(np.isin(train, valid_idx).sum())
            out.update(stage3_steps_per_s=rate, stage3_miou=miou(text))
            print(f"{tag} stage3: {n_steps} steps of {cfg.num_rays} + "
                  f"{cfg.num_local_sample} patches of "
                  f"{cfg.local_sample_patch_size}^2 rays on {n_train} "
                  f"views, {rate:.1f} steps/s, loss {vals[0]:.4f} -> "
                  f"{vals[-1]:.4f}, MeanIoU {miou(text):.4f}", flush=True)
        else:
            out["MeanIoU"] = miou(text)
            print(f"{tag} stage3_test: MeanIoU {out['MeanIoU']:.4f} "
                  f"(resumed)", flush=True)
        print(f"{tag} {stage}: {dt:.2f} s", flush=True)
        if stage == "distill":
            print(f"{tag} distill launches " + ", ".join(
                f"{k} {v}" for k, v in launches.items() if v), flush=True)
        else:
            check_counts(f"{tag} {stage}", launches, rich_expected(
                stage, field, cfg, n_steps, pv, len(val), V, n_train))
            for k, parts in PARTS.items():
                assert all(launches[p] == launches[k] for p in parts)
        del trainer
        torch.cuda.empty_cache()
    want = [st for st in RICH_ORDER if distill_iters or st != "distill"]
    assert stages_run == want, stages_run
    out["seconds"]["chain"] = time.perf_counter() - t_chain
    out["losses_finite"] = finite
    floors = gates or {"PSNR": RICH_ALL_PSNR}
    print(f"{tag} gates on {device_line()}: losses finite {finite}; "
          + ", ".join(f"{k} {out[k]} >= {v}" for k, v in floors.items()),
          flush=True)
    assert finite, out
    for k, v in floors.items():
        assert out[k] >= v, (k, out[k], v)
    return out


def rich_composable(work):
    """The bench script's stage 1 (FIELD=mlp KIND=rich, its flags read out
    of the script, on the scene under work) with the MLP field's level
    kernels off: the composable route, on which the JAX package trained
    the CP-64 field when it recorded the rich scene's quality (its kernels
    took CP features later).  Held-out PSNR, SSIM and LPIPS, and the
    launches (K8 and K10, K1-K7 none)."""
    env = {**RICH_ENV, "KIND": "rich", "FIELD": "mlp",
           "SCENE": os.path.join(work, "rich_llff"),
           "WS": os.path.join(work, "rich_composable_ws")}
    argv = next(w[1:] for w in script_runs("bench_rich_scene.sh", env)
                if w[0] == "main.py" and rich_stage(w[1:]) == "stage1")
    tag = "[rich mlp rich, composable route]"
    print(f"{tag} stage1: python -m sanerf_hq_tpu_torch {' '.join(argv)} "
          f"(MLPField.supports_fused_final off)", flush=True)
    mlp_field.MLPField.supports_fused_final = False
    try:
        trainer, dt, launches = run_cli(argv)
    finally:
        mlp_field.MLPField.supports_fused_final = True
    text = log_text(trainer)
    losses = trainer.stats["loss"]
    q = _eval_metrics(text)
    out = {"PSNR": q["PSNR"], "SSIM": q["SSIM"], "LPIPS": q["LPIPS"],
           "stage1_steps_per_s": log_rate(text, "training"), "seconds": dt,
           "losses_finite": bool(np.isfinite(losses).all()),
           "launches": launches}
    print(f"{tag} stage1: {trainer.state.step} steps in {dt:.2f} s, "
          f"{out['stage1_steps_per_s']:.1f} steps/s; held-out PSNR "
          f"{q['PSNR']:.4f}, SSIM {q['SSIM']:.4f}, LPIPS {q['LPIPS']:.4f}; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                   if v), flush=True)
    assert out["losses_finite"] and q["PSNR"] >= RICH_ALL_PSNR, out
    for k in LEVEL_KERNELS:
        assert launches[k] == 0, launches
    del trainer
    torch.cuda.empty_cache()
    return out


def rich_all():
    """`--rich-all`: the bench script's chain three more ways, each at its
    full run lengths: DISTILL_ITERS=5000 on the MLP field (stage 2b, and
    a second run of phase 16's chain), FIELD=hashgrid, and KIND=clutter
    (its extrapolated views held out); then the MLP field's stage 1 on the
    composable route (rich_composable).  Floors only: finite losses and
    held-out PSNR >= RICH_ALL_PSNR."""
    dev_line = device_line()
    print(dev_line, flush=True)
    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    print(f"[build] {sorted(logs) or 'up to date'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    work = os.path.join(ROOT, "build", "rich_all")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"mlp_rich_distill": rich_chain(work, "mlp", "rich",
                                          distill_iters=5000, gates=None),
           "hashgrid_rich": rich_chain(work, "hashgrid", "rich", gates=None),
           "mlp_clutter": rich_chain(work, "mlp", "clutter", gates=None),
           "mlp_rich_composable": rich_composable(work)}
    print(json.dumps({"rich_all": out}), flush=True)
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--dp-worker"] and len(argv) == 2:
        return dp_worker(argv[1])
    if argv == ["--dp-cards"]:
        return dp_cards()
    if argv == ["--rich-all"]:
        return rich_all()
    ab, k11_only = argv == ["--ab"], argv == ["--k11"]
    if argv and not (ab or k11_only):
        print(f"error: unknown arguments {argv} (none, --ab, --k11, "
              f"--dp-cards or --rich-all)", file=sys.stderr)
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

    if k11_only:
        print(json.dumps({"K11": check_hash_kernel(torch.device("cuda"))}))
        print(dev_line)
        return 0
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
    kernels["K11"] = check_hash_kernel(torch.device("cuda"))
    with torch.inference_mode():
        shard_errs = check_shard_sizes(field)
    launches, mrays = main_path(work)
    trainer, train_launches, sps, train_step = train_path(work)
    parity = grad_parity(trainer, os.path.join(work, "scene"))
    s3_launches, s3 = stage3_path(work, os.path.join(work, "train_ws"))
    hg_trainer, hg_launches, hg = hashgrid_train_path(work)
    hg["card_vs_cpu"] = card_vs_cpu(hg_trainer, os.path.join(work, "scene"))
    hg["packed"] = packed_path(work)
    tr_launches, trainable = stage3_trainable_path(work)
    scripts = scripts_path(work)
    sam = sam_path(work)
    print(json.dumps({"sam_path": sam}), flush=True)
    distill = distill_path(work)
    print(json.dumps({"distill_path": distill}), flush=True)
    viewer = viewer_path(work)
    print(json.dumps({"viewer_path": viewer}), flush=True)
    dp = dp_path(work)
    dp["shard_kernel_errors"] = shard_errs
    print(json.dumps({"dp_path": dp}), flush=True)
    rich_work = os.path.join(work, "rich")
    os.makedirs(rich_work)
    rich = rich_chain(rich_work)
    print(json.dumps({"rich_path": rich}), flush=True)
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
    # K11: replaces no TPU kernel (JAX's encoder is XLA); its launches
    # those of phase 8's stage 1 and phase 11's stage 3
    report.append({"name": "hash_encode_cuda", "route": "cuda",
                   "source": SOURCE_HASH, "replaces": None,
                   "launches": hg_launches["K11"]
                   + scripts["launches"]["stage3"]["K11"],
                   "library_ms": None, **kernels["K11"]})
    # phase 16's launches, summed over the bench script's stages
    for row in report:
        kid = counter.get(row["name"], "K8")  # K9's row runs K8's code
        row["rich_launches"] = sum(c[kid] for c in rich["launches"].values())
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
                      "scripts_path": scripts, "rich_path": rich}))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
