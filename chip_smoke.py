#!/usr/bin/env python3
"""Card check of the PyTorch port (`racformer_tpu_torch`) on NVIDIA GPUs.

    python3 chip_smoke.py                   # needs at least one CUDA card

It checks: each hand kernel against its plain version, the port's paths
on the card against their plain versions and the CPU, launch counts, and
the drivers end to end. It times only the kernels alone at their sites
(ms, plain ms, bound, share, library call) and the matching kernel
against the host solver; step rates, idle shares, peaks and splits are
the benchmark's (`h100_bench/run.py`, `--trace 1`) and
`racformer_tpu_torch.tools.profile_gpu`'s.

Phases, each printed as it runs; any failure exits non-zero:
  1. card and settings: the card's name and power limit, both TF32 flags
     (set off by `racformer_tpu_torch/utils/precision.py`, as the drivers
     set them: the f32 head runs in full f32);
  2. building the CUDA kernels K1-K4 and the matching kernel (csrc/*.cu)
     from this checkout, one nvcc per source, all at once, each kernel's
     registers and spills, and the native data loader
     (csrc/dataloader.cpp, g++ -ljpeg) where the toolchain allows;
  3. K1 against its plain PyTorch version at the three decoder sites' flagship
     shapes, f32 and bf16 maps, ~20% of the points outside the map, each
     timed with its plain version and its bound; K1 on the edges of its
     walk at the image site (one output per slab, a ragged tile, folds 1,
     3, 5 and 33, the last column and row, every point on the zero border,
     zero weights, clustered points);
  4. the streaming eval path: the flagship model of the port's config
     racformer_tpu_torch/configs/racformer_r50_nuimg_704x256_f8.py with
     seeded random weights, fed seeded synthetic ring-camera frames through
     `StreamingEvaluator.step`; K1 must launch 18 times per step (3 sites x 6
     decoder iterations); the encoder and the decoder replayed as CUDA
     graphs from the second step, the last window's replay bitwise its
     eager decode, and (a fresh evaluator, deterministic algorithms) a
     frame's replayed encode bitwise its eager encode;
     on one more step, the in-view share of the image sample points and K1
     on the step's own inputs at each site (their alignment, against the
     plain version, the distinct-column share);
  5. the last window decoded again with K1 routed to the plain version;
  6. a small config run on the card (kernel) and on the CPU (plain version);
  7. K2, K3 and K4 against their plain versions at the training path's
     flagship shapes (image site: 32 slabs x 18,480 points x 4 levels; BEV
     sites: 8 slabs x 123,200 points), f32 and bf16 maps, ~20% of the points
     outside the map; each timed with its plain version, its bound (bytes
     counted from the points' unique map columns, or operations) and one
     PyTorch call of the same function (`F.grid_sample`,
     `aten.grid_sampler_2d_backward`); K3's bucketing against its plain
     version, and a clustered case at the image site (90% of the points in
     5% of the rows); K2 and K4 on the edges of their point tiling at the
     image site (K = 1 and 33, the last column and row, every point on the
     zero border, the clustered points);
  8. the training path: the flagship config's train step (batch 2 in 2
     microbatches, seeded random weights, batches of the port's
     `SyntheticDataset`) for 5 steps through the train driver's `build`;
     per step K2 must launch 72 times (3 sites x 6 iterations x 2 microbatches,
     twice: the forward and the checkpointed recompute), K3 and K4 36 times;
     losses and gradients finite, trainable parameters moved, frozen ones not;
     K2, K3 and K4 on one step's own inputs at each map shape against their
     plain versions, with the points' row, column and distinct-column
     statistics;
  9. one flagship train step with the kernels and one with their plain
     versions, from equal weights, batch and draws: losses and gradients
     compared;
 10. a small f32 config's train step on the card (kernels) and on the CPU
     (plain versions);
 11. (run after phase 6) the multi-stream protocol: 4 ring-camera streams in
     lockstep through `StreamingEvaluator.step_batch` for 10 steps, stream 1
     resetting at step 4 and stream 2 at step 7 while the others keep their
     windows; K1 must launch 18 times per step, as at B = 1; K1 on one
     4-stream step's own inputs at each site, timed with its plain version
     and its bound; each stream against its own `step()` sequence (head
     outputs within phase 5's bound, decoded scores and boxes matched);
     B = 1 `step_batch` against `step()` bit for bit, with deterministic
     algorithms;
 12. (run after phase 11) the offline protocol: `OfflineEvaluator` at batch
     1 over 3 samples of the port's SyntheticDataset at full width: finite
     decoded boxes, 18 K1 launches per sample;
 13. the eval driver `python -m racformer_tpu_torch.eval`, in process, on a
     split it writes in the nuScenes info layout (4 scenes x 2 keyframes, 6
     cameras of 1600x900 JPEG, sweeps, radar, GT) in the three protocols
     (--streaming --streams 4, --streaming, offline): each prints its eval
     line and the metrics; the 4-stream and single-stream predictions
     matched sample by sample; the image-decode path printed.
 14. the train driver `python -m racformer_tpu_torch.train`, in process, on
     the flagship config with --synthetic (4 samples, 2 steps per epoch, an
     in-training offline eval of 2 samples at every epoch, the metrics
     logged every step): run A --max-steps 2 --ema --match-stats, run B
     --max-steps 4 --resume --ema --match-stats in the same work dir, then
     the eval driver on the work dir (--checkpoint, offline, 2 samples);
     each checkpoint verified, run B's restored state bitwise the one run A
     saved (by digest), one val record per epoch, a best checkpoint, match
     statistics per decoder layer and epoch, K2 / K3 / K4 at phase 8's
     counts in every step and K1 at 18 per eval sample, the eval driver's
     predictions bitwise those of the in-memory model that saved the
     checkpoint (deterministic algorithms); then 2 steps on a
     nuScenes-layout training split (phase 13's writer, JPEG decode,
     ida_aug, bev_aug) through the prefetching loader.
 15. the train driver under torchrun, one process on every card, in one
     torchrun call (`python -m torch.distributed.run --standalone
     --nproc_per_node=<cards> chip_smoke.py --worker train ...`: each rank
     calls the driver's `main` with --distributed --synthetic in process):
     run A --max-steps 3, run B --resume to step 4; on every rank the
     launches of each step (K2 / K3 / K4 at phase 8's counts) and the
     BatchNorm all-reduces per microbatch; rank 0 alone saves (verified) and
     writes metrics.jsonl; every rank of run B restored the saved digest.
     Then, in the same processes, the small config of phase 10 in f32 (one
     row pair per rank) against one process at the same global batch, both
     under deterministic algorithms: first-step losses within 1e-5
     relative; at one rank the parameters after the step within 1e-4 of
     their max, at more ranks the gradients by direction (cosine >= 0.999,
     global relative difference <= 1e-3: rounding in the statistics flips
     the sign of near-zero gradients, and a first AdamW step moves those by
     2 lr);
 16. the eval driver under torchrun on every card (`--worker eval`, under
     deterministic algorithms), offline and --streaming --streams 4 on 8
     synthetic samples in one torchrun call, against the same driver in
     this process: the gathered predictions bitwise at one rank, within
     phase 5's bounds at more; K1 launched on every rank;
 17. the decoder's five remat policies (full, dots, dots_no_batch,
     save_sampled, save_bev), 2 flagship train steps each on the same
     batches and draws, on one model whose seeded weights and optimizer
     state are restored before each policy: launches per step (K2 72 / 72
     / 72 / 36 / 48, K3 and K4 36), step 1's losses and gradients (from the
     same seeded weights) against full's within phase 9's bound. A policy
     that does not fit in the card's memory fails the run.
 18. the VoD config (racformer_tpu_torch/configs/racformer_vod.py: 1
     camera, 1 frame, Q = 600, 3 classes) unreduced, on a split it writes
     in the KITTI-format VoD layout (8 frames of 1936x1216 JPEG with the
     VoD camera's P2, radar .bin files, GT with DontCare): the train driver
     for one epoch of 4 steps (batch 2 in 2 microbatches) with its
     checkpoint and an in-training KITTI eval that keeps the best by
     mAP3D_all; the eval driver on that work dir offline, --streaming and
     --streaming --streams 4, the 4-stream predictions matched to the
     single-stream ones sample by sample; K1 launched 18 times per sample
     (offline, one stream) and per 4-stream step, K2 72, K3 and K4 36 per
     train step, as the flagship's (neither count depends on cameras or
     frames); K1 on a VoD eval step's own inputs and K2-K4 on a VoD train
     step's, against their plain versions, timed, with their bounds; then
     `tools.vod_smoke` (the original's fixture and tiny widths, 10 of its
     40 epochs: 60 steps): every step's grad_norm finite (the losses are
     nan_to_num'd, as the JAX package's are) and the last fifth's mean
     loss below the first fifth's, the untrained and trained mAP3D_all /
     mAP3D_corridor printed; then K1-K4 at the smoke's widths (16 channels
     per group) on its fixture's own inputs, one train step and one eval
     step of the model its driver builds (and one eval step on a frame of
     the VoD-layout split, where the image points are in view), against
     their plain versions.
 19. the model's `head_dtype` and `fused_gather` fields, read from the
     flagship config through `config_kwargs`, on phase 4's seeded weights
     and frames: (a) 5 streaming steps with the f32 head and 5 with
     `head_dtype=bfloat16` (K1 18 a step); the bf16 head's outputs float32
     and finite and, on one window, within the JAX package's drift alarm
     of the f32 head's (median |d box| < 0.5); (b) 2 train steps with the
     f32 head, then 2 with the bf16 head, through the train driver's
     `build` (K2 72, K3 and K4 36 a step): losses, grad_norm and gradients
     finite, every parameter still float32, then K2-K4 on one bf16-head
     step's own inputs against their plain versions; (c) 5 streaming steps
     with `fused_gather=False` (no K1, K2 18 a step, decoded eagerly) and
     its head outputs on one window within phase 5's bound of the folded
     step's; (d) VoVNet V-99-eSE on the flagship's per-frame trunk input
     (6 x 256 x 704) in f32 and bf16 (the four output shapes, the bf16
     relative error per stage) and BEVResNet + FPNLSS on a 128^2 BEV of
     256 channels (shapes).
 20. float16 maps: the flagship config with `model.trunk_dtype` and
     `decoder.gather_dtype` float16 through `config_kwargs`, seeded random
     weights: (a) K1 at the three eval sites and K2-K4 at the three train
     sites of the flagship shapes, each against its plain version
     (`force_reference()`) on the same inputs, at phases 3's and 7's
     tolerances scaled to float16's epsilon (one output rounding: rtol and
     atol 1.25e-3 where bf16 takes 1e-2; K3 2^-10 |ref| where bf16 takes
     2^-7), each with its ms, plain ms, bound, share and library call; (b)
     5 streaming steps (K1 18 a step; the float16 maps' largest |value|)
     and the last window decoded with K1 and with its plain version,
     within phase 5's bound; (c) one train step with K2-K4 (72, 36, 36) and
     one with their plain versions from equal weights, batch and draws,
     within phase 9's bound. If the seeded weights overflow float16 on both
     paths of (b) or (c), the run prints it and goes on (the kernels are
     held at the op level in (a)); an overflow on one path fails.
 21. the fork's front-only configuration unreduced (the port's copy of
     racformer_r50_nuimg_704x256_f8_3cam_3rad.py: 3 front cameras, 3
     radars, 8 frames, 256x704, Q = 900, C = 256, 6 layers, D = 96, BEV
     128^2, `eval_front_only`), seeded random weights: (a) K1 at its three
     eval sites and K2-K4 at its three train sites (the image map of 3 x
     rcat rows), bf16 maps, against their plain versions at phases 3's and
     7's tolerances, each with its ms, plain ms, bound, share and library
     call; (b) 5 streaming steps (K1 18 a step) and the last window against
     K1's plain version (phase 5's bound); (c) one train step (batch 2 in
     2 microbatches; K2 / K3 / K4 72 / 36 / 36) against one with the plain
     versions (phase 9's bound); (d) the eval driver with the _mini config
     on phase 13's split (its reader takes the three front cameras of
     six), --streaming and offline: finite predictions, the eval line and
     the metrics, K1 18 a sample, and the front-only filter acting (the GT
     boxes the metrics count with the filter, fewer than without and more
     than none); (e) the train driver 2 steps (one epoch of 4 keyframes) on
     that split with an in-training front-only eval of 2 samples: finite
     losses, launches per step as (c), a verified checkpoint.
 22. (run after phase 9) the train loss's matching kernel
     (`csrc/lap_assign.cu`, `train.matching.hungarian_assign`) against the
     host solver `assign_host` on [6, 1, 900, 64] losses' costs with 5, 32
     and 64 valid GT rows and on the cost of one flagship train step's own
     forward: equal bit for bit, the kernel's ms a call (CUDA events), the
     host solver's ms, the Dijkstra steps (a counting copy of `lap_single`)
     and the kernel's us per step of its longest problem, and the launches.
The K1 entry of the kernels line counts its launches on phases 4, 11, 12,
13, 14, 16, 18, 19 and 21, the K2-K4 entries theirs on phases 8, 14, 15,
17, 18, 19 and 21,
each counted from 0 just before the phase's run (phases 15 and 16 count in
their processes and report back, summed over the ranks); the times of its
first four entries are phases 3's and 7's bf16 sites summed; the four
`*_float16` entries hold phase 20's float16 runs: times, bounds and errors
summed over (a)'s sites, launches from (b)'s steps and (c)'s kernel step.
No module of JAX or of the JAX package may have been imported by the end.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import runpy
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "racformer_tpu_torch" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
SEED = 0
STEPS = 12
OUTSIDE_SHARE = 0.2


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM device memory, NVIDIA data sheet
F32_OPS_PER_MS = 67e12 / 1e3  # f32 outside the tensor cores (the samplers')
# f32 operations per point and channel (of C), from the plain versions'
# arithmetic: x-lerp of both halves 6, y-mix 3; K1 adds the scalar weight and
# the fold sum; K3 2 y-products, 4 x-products, 4 adds; K4 8 per location
# gradient
OPS_PER_POINT_CHANNEL = {"gather_fold": 11, "patch_gather": 9,
                         "patch_scatter": 10, "patch_corner_grads": 16}


def unique_columns(shape, row, x0p):
    """Distinct (slab, row, column) map columns that the points read: the
    columns x0p and x0p + 1 of each point's fused row."""
    from racformer_tpu_torch.ops import gather_kernel as gk

    idx = gk.flat_index(shape, row, x0p)
    return torch.unique(torch.cat([idx, idx + 1])).numel()


def bound_ms(kernel, shape, pts, es, fold=1, reread=False):
    """(least ms, 'bytes' or 'operations') of one call of `kernel` on a map
    of `shape` and points `pts` (row, x0p, wx, wy[, wl]), elements of `es`
    bytes: each input byte read once (map columns counted once however many
    points read them, as these inputs need), each output byte written once,
    against the operations over the f32 rate. With `reread`, each point's
    two columns count as read from device memory (no reuse in L2)."""
    S, R, Wp, C2 = shape
    C = C2 // 2
    n = pts[0].numel()
    per_point = 4 * len(pts)  # int32 / f32 per-point inputs
    cols = lambda: (2 * n if reread else unique_columns(shape, pts[0], pts[1])
                    ) * C2 * es
    nbytes = {
        "gather_fold": lambda: cols() + n * per_point + n // fold * C * es,
        "patch_gather": lambda: cols() + n * per_point + n * C * es,
        "patch_scatter": lambda: n * C * es + n * per_point + S * R * Wp * C2 * es,
        "patch_corner_grads": lambda: cols() + n * C * es + n * per_point + n * 8,
    }[kernel]()
    t_b = nbytes / HBM_BYTES_PER_MS
    t_o = n * C * OPS_PER_POINT_CHANNEL[kernel] / F32_OPS_PER_MS
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def coords(gen, shape, dev):
    """Normalized coordinates in [0, 1], with OUTSIDE_SHARE of the points
    moved off the map in x (far and near, both sides)."""
    x = torch.rand(shape, generator=gen, device=dev)
    y = torch.rand(shape, generator=gen, device=dev)
    out = torch.rand(shape, generator=gen, device=dev) < OUTSIDE_SHARE
    side = torch.rand(shape, generator=gen, device=dev)
    off = torch.where(side < 0.5, -0.01 - side * 2.0, 1.01 + (side - 0.5) * 2.0)
    return torch.where(out, off, x), y, out


def site_cases(model, gen, dtype, dev):
    """(name, map, per-point inputs, fold, outside share) for the decoder's
    three K1 call sites at the model's shapes."""
    from racformer_tpu_torch.nn.img_sampling import concat_geometry
    from racformer_tpu_torch.ops.bilinear import sampler_ready
    from racformer_tpu_torch.ops.deform_attn import bev_fold_inputs
    from racformer_tpu_torch.ops.msmv import image_fold_inputs

    layer = model.pts_bbox_head.transformer.decoder.decoder_layer
    T, N, Q = model.num_frames, model.num_cams, model.pts_bbox_head.num_query
    G, L = model.num_groups, model.num_levels
    c = model.embed_dims // G
    img = layer.sampling
    P = img.num_points * img.depth_num
    hws, roffs, rcat = concat_geometry(model.image_hw, L)
    S = T * G
    levels = [sampler_ready(torch.randn(S, N, h, w, c, generator=gen, device=dev)
                            .to(dtype)) for h, w in hws]
    wmax = max(f.shape[-2] for f in levels)
    fmap = torch.cat([torch.nn.functional.pad(f, (0, 0, 0, wmax - f.shape[-2]))
                      for f in levels], dim=-3).reshape(S, N * rcat, wmax, 2 * c)
    x, y, out = coords(gen, (S, Q, P), dev)
    view = torch.randint(0, N, (S, Q, P), generator=gen, device=dev)
    w = torch.softmax(torch.randn(S, Q, P, L, generator=gen, device=dev), -1)
    cases = [("image", fmap, image_fold_inputs(x, y, view, w, hws, roffs, rcat),
              L, out.float().mean().item())]
    for name in ("radar_bev", "lss_bev"):
        bev = getattr(layer, f"sampling_{name}")
        H, W = bev.spatial_shape
        M = bev.num_heads
        Pb = bev.num_points * bev.depth_num
        vmap = sampler_ready(torch.randn(T, M, H, W, c, generator=gen, device=dev)
                             .to(dtype))
        R0 = vmap.shape[2]
        x, y, out = coords(gen, (T, Q, M, Pb), dev)
        w = torch.softmax(torch.randn(T, Q, M, Pb, generator=gen, device=dev), -1)
        cases.append((name, vmap.reshape(T, M * R0, *vmap.shape[3:]),
                      bev_fold_inputs(x, y, w, (H, W), R0), bev.num_points,
                      out.float().mean().item()))
    return cases


def ring_frames(model, n, points, seed):
    """Synthetic frames: cameras on a ring around the ego car looking
    outwards (500 px focal length), uint8 images, radar points and dense
    radar depth / RCS maps, scene-relative timestamps 0.5 s apart."""
    rng = np.random.default_rng(seed)
    N, (H, W) = model.num_cams, model.image_hw
    l2i = np.broadcast_to(np.eye(4, dtype=np.float32), (N, 4, 4)).copy()
    for cam in range(N):
        yaw = 2 * np.pi * cam / N
        R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1],
                      [np.cos(yaw), np.sin(yaw), 0]], np.float32)
        K = np.array([[500, 0, W / 2], [0, 500, H / 2], [0, 0, 1]], np.float32)
        l2i[cam, :3, :3] = K @ R
    i2l = np.linalg.inv(l2i).astype(np.float32)
    return [dict(
        imgs=rng.integers(0, 256, size=(N, H, W, 3), dtype=np.uint8),
        radar_points=(rng.normal(size=(points, 7)) * 10).astype(np.float32),
        radar_mask=np.ones((points,), bool),
        radar_depth=rng.uniform(0, 60, size=(N, H, W)).astype(np.float32),
        radar_rcs=rng.uniform(-30, 30, size=(N, H, W)).astype(np.float32),
        lidar2img=l2i, img2lidar=i2l, timestamp=0.5 * t) for t in range(n)]


def phase_card():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke run "
                           "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    from racformer_tpu_torch.utils.precision import pin_float32_precision

    pin_float32_precision(lambda line: print(f"[1] {line}"))
    return card


def phase_build():
    from racformer_tpu_torch.ops import cuda_lib

    cuda_lib.build_all()
    sources = ", ".join(sorted({f"csrc/{src}" for src, _, _ in
                                cuda_lib.KERNELS.values()}))
    print(f"[2] built K1-K4 and the matching kernel ({sources}; sm_90a, one "
          f"nvcc each, in parallel)")
    for name, log in cuda_lib.build_logs.items():
        for line in ptxas_report(log, name in POINT_TILE_KERNELS):
            print(f"[2] ptxas {name} {line}")
    from racformer_tpu_torch.data import native

    print(f"[2] native data loader (csrc/dataloader.cpp, g++ -ljpeg): "
          + (f"built at {native.library_path()}" if native.available() else
             "not available (no g++ or libjpeg to build or load it): "
             "images decode with PIL"))


def ptxas_report(log, point_tiles):
    """The register and spill lines of nvcc's `-Xptxas -v` output, each
    after its kernel's name (name<type>); for a point-tile kernel with the
    blocks per SM its registers allow."""
    entry, lines = "?", []
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = kernel_name(m.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        occupancy = ""
        if regs and point_tiles:
            occupancy = (f"; blocks of 256 threads per SM by registers: "
                         f"{blocks_by_registers(int(regs.group(1)))}")
        if regs or "spill" in line:
            lines.append(f"{entry}: {line.strip()}{occupancy}")
    return lines


# the kernels of csrc/point_tiles.cuh: blocks of 8 warps, no shared memory,
# so registers alone set how many blocks an SM holds
POINT_TILE_KERNELS = ("gather_fold", "patch_gather", "patch_corner_grads")


def kernel_name(mangled):
    """name<type> of a mangled kernel template name (_ZN, then <length><name>
    for each enclosing namespace and the kernel, then I<type>E), else the
    mangled name's first 60 characters."""
    rest, names = mangled[3:] if mangled.startswith("_ZN") else "", []
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        end = len(digits) + int(digits)
        names.append(rest[len(digits):end])
        rest = rest[end:]
    for prefix, dtype in (("IfE", "float"), ("I13__nv_bfloat16E", "bf16"),
                          ("I6__halfE", "f16")):
        if names and rest.startswith(prefix):
            return f"{names[-1]}<{dtype}>"
    return mangled[:60]


def blocks_by_registers(regs, warps=8):
    """Blocks of `warps` warps that fit an SM's 65,536 registers at `regs`
    per thread (allocated per warp in units of 256), at most 64 warps."""
    per_warp = -(-regs * 32 // 256) * 256
    return min(64, 65536 // per_warp) // warps


def rounding_tol(dtype):
    """The relative tolerance for one output rounding to a 16-bit dtype on
    each side: 1e-2 in bf16 (steps of 2^-7), scaled by the dtype's epsilon:
    1.25e-3 in float16 (steps of 2^-10)."""
    return 1e-2 * torch.finfo(dtype).eps / torch.finfo(torch.bfloat16).eps


def fold_ok(got, want):
    """K1 against its plain version: (ok, max abs error, tolerance). f32:
    the same f32 arithmetic, the fold sum in another order, atol 1e-5; bf16
    and f16: one output rounding each, rtol + atol rtol max|ref| with rtol
    `rounding_tol` (1e-2 bf16, 1.25e-3 f16)."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if got.dtype == torch.float32:
        return err <= 1e-5, err, "atol 1e-5"
    tol = rounding_tol(got.dtype)
    atol = tol * want.float().abs().max().item()
    return (bool((diff <= atol + tol * want.float().abs()).all()), err,
            f"rtol {tol:g} + atol {atol:.3g} ({tol:g} max|ref|)")


def phase_kernel(model, dev):
    from racformer_tpu_torch.ops import gather_kernel as gk

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, ms, plain_ms, bound, bound_by = [], 0.0, 0.0, 0.0, set()
    for dtype in (torch.float32, torch.bfloat16):
        for name, fmap, pts, fold, outside in site_cases(model, gen, dtype, dev):
            got = gk.patch_sample_fold(fmap, *pts, fold)
            want = gk.patch_sample_fold_reference(fmap, *pts, fold)
            torch.cuda.synchronize()
            ok, err, tol = fold_ok(got, want)
            del got, want
            t_k = median_ms(lambda: gk.patch_sample_fold(fmap, *pts, fold))
            t_p = median_ms(lambda: gk.patch_sample_fold_reference(
                fmap, *pts, fold), reps=5, warmup=1)
            t_b, by = bound_ms("gather_fold", fmap.shape, pts,
                               fmap.element_size(), fold)
            print(f"[3] K1 {name:9s} {str(dtype):14s} map {tuple(fmap.shape)} "
                  f"K={pts[0].shape[1]} fold={fold} outside={outside:.3f}: "
                  f"max_abs_err={err:.3g} ({tol}) {'ok' if ok else 'FAIL'}; "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                  f"{t_b:.4f} ms ({by}), share {t_b / t_k:.3f}; library: none")
            check(ok, f"K1 disagrees with its plain version at {name} {dtype}")
            errs.append(err)
            if dtype == torch.bfloat16:  # the main path's map dtype
                ms += t_k
                plain_ms += t_p
                bound += t_b
                bound_by.add(by)
            if name == "image":
                fold_edge_cases(fmap, pts, fold, gen)
    return max(errs), ms, plain_ms, bound, "/".join(sorted(bound_by))


def fold_edge_cases(fmap, pts, fold, gen):
    """K1 against its plain version on the edges of its walk
    (csrc/gather_fold.cu), on the image site's map: one output per slab,
    outputs that leave a ragged warp tile, other folds (1, 3, 5, and 33,
    whose outputs span two windows of 32 points), points at the last column
    and the last row, every point on the zero border (exactly zero), points
    of zero weight, and clustered points."""
    from racformer_tpu_torch.ops import gather_kernel as gk

    S, R, Wp, _ = fmap.shape
    row, x0p, wx, wy, wl = pts
    K, dev = row.shape[1], row.device
    idx = torch.arange(K, device=dev)
    border = torch.tensor([0, Wp - 2], dtype=torch.int32, device=dev)

    def first(k, slabs=S):
        return fmap[:slabs], [t[:slabs, :k] for t in pts]

    cases = {
        f"K = fold = {fold}": (*first(fold), fold),
        f"3 slabs, K / fold = 11 (33 outputs: 4 tiles of 8 and 1)":
            (*first(11 * fold, 3), fold),
        "last column (x0p = Wp - 2) and last row (row = R - 1)": (
            fmap, [torch.where(idx % 3 == 0, R - 1, row),
                   torch.where(idx % 2 == 0, Wp - 2, x0p), wx, wy, wl], fold),
        "all outside (x0p in 0, Wp - 2: zero border)": (
            fmap, [row, border[idx % 2].expand(S, K), wx, wy, wl], fold),
        "wl = 0 on every other point": (
            fmap, [row, x0p, wx, wy, torch.where(idx % 2 == 0, 0.0, wl)], fold),
        "clustered (90% of the points in 5% of the rows)": (
            fmap, [clustered(row, R, gen), x0p, wx, wy, wl], fold),
    }
    for f in (1, 3, 5, 33):
        cases[f"fold = {f}"] = (*first(K // f * f), f)
    for case, (m, hot, f) in cases.items():
        hot = [t.to(torch.int32 if i < 2 else torch.float32).contiguous()
               for i, t in enumerate(hot)]
        want = gk.patch_sample_fold_reference(m, *hot, f)
        got = gk.patch_sample_fold(m, *hot, f)
        ok, err, tol = fold_ok(got, want)
        if case.startswith("all outside"):
            check(not want.any(), "K1's plain version is not zero on the zero border")
            ok = ok and not got.any()
            tol = "exactly zero"
        print(f"[3] K1 image, {case} {str(m.dtype):14s}: max_abs_err {err:.3g} "
              f"({tol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"K1 disagrees with its plain version: {case}, {m.dtype}")


def phase_main(model):
    from racformer_tpu_torch.eval import StreamingEvaluator, graphs
    from racformer_tpu_torch.ops import gather_kernel as gk

    frames = ring_frames(model, STEPS + 1, 1536, SEED)
    ev = StreamingEvaluator(model)
    gk.LAUNCHES = 0
    replays = graphs.GRAPH_REPLAYS
    outs = [ev.step(frame, blocking=False) for frame in frames[:STEPS]]
    launches = gk.LAUNCHES
    check(launches == 18 * STEPS,
          f"K1 launched {launches} times in {STEPS} steps, expected {18 * STEPS}")
    (plan,) = ev.decoder_graphs.plans.values()
    (enc,) = ev.encoder_graphs.plans.values()
    replays = graphs.GRAPH_REPLAYS - replays
    check(replays == (enc.graphs + plan.graphs) * (STEPS - 1),
          f"{replays} CUDA graphs replayed in {STEPS} steps, expected "
          f"{enc.graphs} + {plan.graphs} (encoder + decoder) in each step "
          f"after the first")
    exact = replay_equals_eager(model, ev)
    enc_exact = encode_replay_equals_eager(model, frames)
    head = model.pts_bbox_head
    n_boxes = min(300, head.num_query * head.num_classes)
    for out in outs:
        check(tuple(out["bboxes"].shape) == (1, n_boxes, 9), "bad box shape")
        check(bool(torch.isfinite(out["scores"]).all())
              and bool(torch.isfinite(out["bboxes"]).all()),
              "non-finite scores or boxes")
    print(f"[4] {STEPS} streaming steps: K1 launches {launches} "
          f"({launches // STEPS} per step); the encoder replayed as "
          f"{enc.graphs} and the decoder as {plan.graphs} CUDA graphs from "
          f"step 2, the last window's replay "
          f"{'bitwise equal to' if exact else 'DIFFERS from'} its eager "
          f"decode, a frame's encode replayed (deterministic algorithms) "
          f"{'bitwise equal to' if enc_exact else 'DIFFERS from'} its eager "
          f"encode; outputs finite, boxes "
          f"{tuple(outs[-1]['bboxes'].shape)}, valid boxes in last step "
          f"{int(outs[-1]['valid'].sum())}")

    # on one more step: the share of image sample points that some camera
    # sees, and K1's inputs at each site in the first decoder iteration
    seen, caught = capture_fold_inputs(
        lambda: ev.step(frames[STEPS], blocking=False))
    print(f"[4] in-view share of image sample points per decoder iteration: "
          f"{', '.join(f'{s:.3f}' for s in seen)}")
    check(min(seen) > 0.05, "image sample points are (almost) never in view")
    step_fold_inputs(caught, "[4]", timed=False)
    return ev, launches


def replay_equals_eager(model, ev):
    """Decode the evaluator's last window again, replayed as its CUDA graphs
    and eagerly, and check that the head's outputs agree bit for bit. Both
    decode the same window, so only the decoder runs; it adds in no order
    that atomics decide (the encoder's `index_add_` does), so no
    deterministic algorithms are needed, and none change the eager decode's
    kernels against the captured ones."""
    from racformer_tpu_torch.eval import graphs

    replays = graphs.GRAPH_REPLAYS
    (plan,) = ev.decoder_graphs.plans.values()
    with torch.no_grad():
        replayed = {k: v.clone() for k, v in
                    ev.decoder_graphs(model, ev.cache).items()}
        check(graphs.GRAPH_REPLAYS - replays == plan.graphs,
              "the last window's decode did not replay")
        eager = graphs.decode_window(model, ev.cache)
    exact = all(torch.equal(replayed[k], eager[k]) for k in eager)
    check(exact, "a replayed decode differs from the eager decode of its window")
    return exact


def encode_replay_equals_eager(model, frames):
    """A fresh evaluator over three frames (eager, captured, replayed) under
    deterministic algorithms (the encoder's `index_add_`, the LSS splat and
    the pillar sums, otherwise adds in the order its atomics land); the
    encoder's and the decoder's graphs replayed in each step after the
    first; then the last frame's encode replayed and run eagerly, and the
    outputs (image pyramid, LSS and radar BEV maps) checked bit for bit."""
    from racformer_tpu_torch.eval import StreamingEvaluator, graphs

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ev = StreamingEvaluator(model)
        replays = graphs.GRAPH_REPLAYS
        for frame in frames[:3]:
            ev.step(frame, blocking=False)
        (enc,) = ev.encoder_graphs.plans.values()
        (dec,) = ev.decoder_graphs.plans.values()
        check(graphs.GRAPH_REPLAYS - replays == 2 * (enc.graphs + dec.graphs),
              "the encoder or the decoder did not replay in steps 2 and 3")
        with torch.no_grad():
            frame = tuple(x.clone() for x in enc.inputs)
            replayed = [x.clone() for x in ev.encoder_graphs(model, frame)]
            check(graphs.GRAPH_REPLAYS - replays
                  == 2 * (enc.graphs + dec.graphs) + enc.graphs,
                  "the last frame's encode did not replay")
            eager = graphs.encode_frame(model, frame)
    finally:
        torch.use_deterministic_algorithms(False)
    exact = all(torch.equal(r, e) for r, e in zip(replayed, eager))
    check(exact, "a replayed encode differs from the eager encode of its frame")
    return exact


def capture_fold_inputs(run):
    """Run `run()` (one eval step) with K1's call sites spied on. Returns
    (the in-view share of the image sample points per decoder iteration,
    {site: (the addresses of K1's inputs as the step made them, a copy of
    its arguments)} for the first decoder iteration). The step decodes
    eagerly: a decode replayed as CUDA graphs projects its sample points
    inside a graph, where no spy sees them."""
    from racformer_tpu_torch.eval import graphs
    from racformer_tpu_torch.ops import deform_attn, msmv, sampling
    from racformer_tpu_torch.ops import gather_kernel as gk

    seen, caught = [], {}
    orig = sampling.project_points_to_views
    folds = {mod: mod.patch_sample_fold for mod in (msmv, deform_attn)}

    def recording(points, lidar2img, h, w, eps=1e-5):
        x, y, view = orig(points, lidar2img, h, w, eps)
        seen.append(((x > 0) & (x < 1) & (y > 0) & (y < 1)).float().mean().item())
        return x, y, view

    def spy(*args):  # per iteration: radar BEV, LSS BEV, then the image site
        site = ("radar_bev", "lss_bev", "image")[len(caught)] if len(caught) < 3 else None
        if site:
            caught[site] = ([a.data_ptr() for a in args[:6]],
                            [a.clone() if torch.is_tensor(a) else a for a in args])
        return gk.patch_sample_fold(*args)

    sampling.project_points_to_views = recording
    key = graphs.replay_key
    graphs.replay_key = lambda *a: None
    for mod in folds:
        mod.patch_sample_fold = spy
    try:
        run()
    finally:
        sampling.project_points_to_views = orig
        graphs.replay_key = key
        for mod, fn in folds.items():
            mod.patch_sample_fold = fn
    return seen, caught


def step_fold_inputs(caught, tag, timed):
    """K1 on its own inputs from one eval step's first decoder iteration, at
    each site: the maps' 16-byte alignment (the wrapper raises on others),
    the kernel against its plain version and the share of the column reads
    that go to distinct columns (what the bound counts); when `timed`, the
    kernel's and the plain version's ms and the bound."""
    from racformer_tpu_torch.ops import gather_kernel as gk

    for site, (ptrs, args) in caught.items():
        fmap, pts, fold = args[0], args[1:6], args[6]
        shape = tuple(fmap.shape)
        check(all(ptr % 16 == 0 for ptr in ptrs),
              f"K1's inputs at the {site} site are not 16-byte aligned")
        kern = functools.partial(gk.patch_sample_fold, *args)
        ok, err, tol = fold_ok(kern(), gk.patch_sample_fold_reference(*args))
        timing = ""
        if timed:
            t_k = median_ms(kern, reps=10, warmup=2)
            t_p = median_ms(lambda: gk.patch_sample_fold_reference(*args),
                            reps=3, warmup=1)
            t_b, by = bound_ms("gather_fold", shape, pts, fmap.element_size(),
                               fold)
            timing = (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                      f"{t_b:.4g} ms ({by}), share {t_b / t_k:.3g}")
        n = pts[0].numel()
        print(f"{tag} K1 on the step's inputs, {site} map {shape} {fmap.dtype} "
              f"K={pts[0].shape[1]} fold={fold}, map at {ptrs[0]:#x} "
              f"(16-byte aligned): max_abs_err {err:.3g} ({tol}) "
              f"{'ok' if ok else 'FAIL'}{timing}; distinct columns per column "
              f"read {unique_columns(shape, pts[0], pts[1]) / (2 * n):.3f}")
        check(ok, f"K1 disagrees with its plain version on the step's {site} "
                  f"inputs")


def phase_reference(model, ev):
    from racformer_tpu_torch.ops import gather_kernel as gk

    feat_cat, lss, radar, l2i, ts = ev.cache
    td = ts[:, :1] - ts
    a = model.decode_window(feat_cat, lss, radar, l2i, td)
    with gk.force_reference():
        b = model.decode_window(feat_cat, lss, radar, l2i, td)
    d_cls = (a["all_cls_scores"][-1] - b["all_cls_scores"][-1]).abs().max().item()
    d_box = (a["all_bbox_preds"][-1] - b["all_bbox_preds"][-1]).abs().max().item()
    cls_max = b["all_cls_scores"][-1].abs().max().item()
    box_max = b["all_bbox_preds"][-1].abs().max().item()
    print(f"[5] last window, K1 vs plain version: max |d cls logits| {d_cls:.4g} "
          f"(max |cls| {cls_max:.4g}), max |d boxes| {d_box:.4g} "
          f"(max |box| {box_max:.4g})")
    # bf16 maps: both versions round each gathered value to bf16; over six
    # iterations that moves a few logits by a few 1e-2, not by O(1)
    check(d_cls <= 0.1 * max(1.0, cls_max) and d_box <= 0.1 * max(1.0, box_max),
          "main path with K1 drifts from the plain version")


def phase_small(dev):
    from racformer_tpu_torch.model import RaCFormer, preprocess_images, random_init_
    from racformer_tpu_torch.ops import gather_kernel as gk

    tiny = dict(num_cams=2, num_frames=2, embed_dims=256, num_query=12,
                num_clusters=2, image_hw=(64, 128), depth_bins=16,
                bev_size=(32, 32), num_decoder_layers=2,
                trunk_dtype=torch.float32, decoder={"gather_dtype": torch.float32})
    cpu = random_init_(RaCFormer(**tiny), torch.Generator().manual_seed(SEED)).eval()
    gpu = RaCFormer(**tiny).to(dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    model_like = type("M", (), {"num_cams": 2, "image_hw": (64, 128)})
    frames = ring_frames(model_like, 2, 64, SEED + 1)
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames])[None])
             for k in ("imgs", "radar_points", "radar_mask", "radar_depth",
                       "radar_rcs", "lidar2img", "img2lidar")}
    batch["time_diff"] = torch.tensor([[0.0, 0.5]])
    args = [preprocess_images(batch["imgs"])] + [batch[k] for k in (
        "radar_points", "radar_mask", "radar_depth", "radar_rcs", "lidar2img",
        "img2lidar", "time_diff")]
    want = cpu(*args)
    before = gk.LAUNCHES
    got = gpu(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    launched = gk.LAUNCHES - before
    errs = {k: (got[k].cpu() - want[k]).abs().max().item()
            for k in ("all_cls_scores", "all_bbox_preds", "depth_logits")}
    ok = all(torch.allclose(got[k].cpu(), want[k], rtol=1e-3, atol=2e-3)
             for k in errs)
    print(f"[6] small config f32, card (K1, {launched} launches) vs CPU (plain): "
          f"max abs err {errs} (rtol 1e-3, atol 2e-3) {'ok' if ok else 'FAIL'}")
    check(launched == 6 and ok, "small-config run on the card disagrees with CPU")

MS_STREAMS, MS_STEPS = 4, 10
# (stream, step) of the mid-run scene resets: stream 1 at step 4 and stream 2
# at step 7, each while the other streams keep their windows
MS_RESETS = {(1, 4), (2, 7)}
# the decoded scores of two runs of one model: sigmoid's slope is at most
# 1/4, so phase 5's bound of 0.1 on a logit of magnitude <= 1 moves a score
# by at most 0.025, and the k-th largest score by no more
SCORE_TOL = 0.025


class HeadOutputs:
    """The last decoder layer's class logits and boxes of every window the
    streaming evaluator decodes, in call order: what it hands to
    `decode_boxes` (a decode replayed as CUDA graphs calls no module's
    forward, so a forward hook would miss it)."""

    def __init__(self):
        from racformer_tpu_torch.eval import streaming

        self.outs = []
        self.inner = inner = streaming.decode_boxes

        def decode_boxes(cls_scores, bbox_preds, **kw):
            self.outs.append((cls_scores.float().clone(),
                              bbox_preds.float().clone()))
            return inner(cls_scores, bbox_preds, **kw)

        streaming.decode_boxes = decode_boxes

    def close(self):
        from racformer_tpu_torch.eval import streaming

        streaming.decode_boxes = self.inner


def head_bound(ref_cls, ref_box):
    """Phase 5's bound on a window's head outputs: 0.1 of max(1, max|ref|)
    for the class logits and for the boxes."""
    return (0.1 * max(1.0, ref_cls.abs().max().item()),
            0.1 * max(1.0, ref_box.abs().max().item()))


def decoded_match(got, want):
    """(ok, max |d score|, boxes matched, max |d box| of the matches) of two
    decoded outputs of one frame (scores sorted descending, labels, [max_num,
    9] boxes). The k-th scores must agree within SCORE_TOL. A box of `got`
    scored more than 2 SCORE_TOL above `want`'s last score is a pair (query,
    class) that `want` holds too, so it must find there a box of its label,
    with a score within SCORE_TOL, that agrees within 0.1 of max(1, |box|)
    (phase 5's form) in all nine fields."""
    gs, ws = (np.asarray(x["scores"], np.float64) for x in (got, want))
    gb, wb = (np.asarray(x["bboxes"], np.float64) for x in (got, want))
    gl, wl = np.asarray(got["labels"]), np.asarray(want["labels"])
    d_score = float(np.abs(gs - ws).max())
    tol = 0.1 * np.maximum(1.0, np.abs(wb))
    ok, matched, worst = d_score <= SCORE_TOL, 0, 0.0
    for i in np.flatnonzero(gs > ws[-1] + 2 * SCORE_TOL):
        cand = (wl == gl[i]) & (np.abs(ws - gs[i]) <= SCORE_TOL)
        diff = np.abs(wb[cand] - gb[i])
        fits = (diff <= tol[cand]).all(axis=1)
        if fits.any():
            matched += 1
            worst = max(worst, float(diff[fits].max(axis=1).min()))
        else:
            ok = False
    return ok, d_score, matched, worst


def multistream_tapes(model):
    """Per stream, MS_STEPS + 1 ring-camera frames and their resets (its
    first step and MS_RESETS), timestamps relative to the stream's scene
    start."""
    tapes = []
    for b in range(MS_STREAMS):
        frames = ring_frames(model, MS_STEPS + 1, 1536, SEED + 10 + b)
        resets, start = [], 0
        for t, f in enumerate(frames):
            reset = t == 0 or (b, t) in MS_RESETS
            start = t if reset else start
            f["timestamp"] = 0.5 * (t - start)
            resets.append(reset)
        tapes.append((frames, resets))
    return tapes


def phase_multistream(model):
    """B = 4 lockstep streams through `step_batch` at full width."""
    from racformer_tpu_torch.eval import StreamingEvaluator
    from racformer_tpu_torch.ops import gather_kernel as gk

    B = MS_STREAMS
    tapes = multistream_tapes(model)
    frames_at = lambda t: [tapes[b][0][t] for b in range(B)]
    resets_at = lambda t: [tapes[b][1][t] for b in range(B)]
    ev = StreamingEvaluator(model)
    heads = HeadOutputs()
    torch.cuda.empty_cache()
    gk.LAUNCHES = 0
    outs = [ev.step_batch(frames_at(t), resets_at(t), blocking=False)
            for t in range(MS_STEPS)]
    launches = gk.LAUNCHES
    batched = list(heads.outs)
    check(launches == 18 * MS_STEPS,
          f"K1 launched {launches} times in {MS_STEPS} B = {B} steps, expected "
          f"{18 * MS_STEPS}")
    head = model.pts_bbox_head
    n_boxes = min(300, head.num_query * head.num_classes)
    for out in outs:
        check(tuple(out["bboxes"].shape) == (B, n_boxes, 9), "bad box shape")
        check(bool(torch.isfinite(out["scores"]).all())
              and bool(torch.isfinite(out["bboxes"]).all()),
              "non-finite scores or boxes")
    print(f"[11] {MS_STEPS} lockstep steps of {B} streams (resets at (stream, "
          f"step) {sorted(MS_RESETS)}): K1 launches {launches} "
          f"({launches // MS_STEPS} per step, as at B = 1); outputs finite, "
          f"boxes {tuple(outs[-1]['bboxes'].shape)}")

    # K1 on one more B = 4 step's own inputs, at the three sites
    _, caught = capture_fold_inputs(lambda: ev.step_batch(
        frames_at(MS_STEPS), [False] * B, blocking=False))
    step_fold_inputs(caught, "[11]", timed=True)
    del caught, ev
    torch.cuda.empty_cache()

    # each stream against its own step() sequence (the same model, B = 1)
    heads.outs.clear()
    d_cls = d_box = d_score = d_dec = 0.0
    compared, ok = 0, True
    for b in range(B):
        single = StreamingEvaluator(model)
        frames, resets = tapes[b]
        for t in range(MS_STEPS):
            if resets[t]:
                single.reset()
            ref = single.step(frames[t])
            ref_cls, ref_box = heads.outs[-1]
            tol_cls, tol_box = head_bound(ref_cls, ref_box)
            e_cls = (batched[t][0][b] - ref_cls[0]).abs().max().item()
            e_box = (batched[t][1][b] - ref_box[0]).abs().max().item()
            good, e_score, n, e_dec = decoded_match(
                {k: v[b].cpu().numpy() for k, v in outs[t].items()},
                {k: v[0] for k, v in ref.items()})
            ok = ok and good and e_cls <= tol_cls and e_box <= tol_box
            d_cls, d_box = max(d_cls, e_cls), max(d_box, e_box)
            d_score, compared = max(d_score, e_score), compared + n
            d_dec = max(d_dec, e_dec)
    print(f"[11] each stream against its own step() sequence: head max |d cls "
          f"logits| {d_cls:.4g}, max |d boxes| {d_box:.4g} (bound 0.1 max(1, "
          f"max|ref|) each, phase 5's); decoded scores max |d| {d_score:.4g} "
          f"(bound {SCORE_TOL}); {compared} decoded boxes matched, max |d| "
          f"{d_dec:.4g} (bound 0.1 max(1, |box|)) {'ok' if ok else 'FAIL'}")
    check(ok, "a stream of the B = 4 run disagrees with its own step() sequence")

    # B = 1 lockstep against step(), stream 1 (its reset at step 4 included),
    # with deterministic algorithms: index_add_ (the LSS splat, the pillar
    # sums) otherwise adds in the order its atomics land
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        frames, resets = tapes[1]
        lock, single = StreamingEvaluator(model), StreamingEvaluator(model)
        heads.outs.clear()
        exact = True
        for t in range(6):
            got = lock.step_batch([frames[t]], [resets[t]], blocking=False)
            if resets[t]:
                single.reset()
            want = single.step(frames[t], blocking=False)
            exact = exact and all(torch.equal(got[k], want[k]) for k in want)
            exact = exact and all(torch.equal(x, y) for x, y in
                                  zip(heads.outs[-2], heads.outs[-1]))
    finally:
        torch.use_deterministic_algorithms(False)
        heads.close()
    print(f"[11] B = 1 step_batch against step() over 6 steps of stream 1 "
          f"(reset at step 4), deterministic algorithms: decoded outputs and "
          f"head outputs {'bitwise equal' if exact else 'DIFFER'}")
    check(exact, "B = 1 step_batch differs from step()")
    return launches


OFFLINE_SAMPLES = 3


def phase_offline(model):
    """`OfflineEvaluator` at batch 1 over the port's SyntheticDataset at
    full width: every frame of each sample's window encoded, decoded."""
    from racformer_tpu_torch.data import SyntheticDataset
    from racformer_tpu_torch.eval import OfflineEvaluator
    from racformer_tpu_torch.ops import gather_kernel as gk

    ds = SyntheticDataset(num_samples=OFFLINE_SAMPLES, num_cams=model.num_cams,
                          num_frames=model.num_frames, hw=model.image_hw,
                          max_radar_points=1536, max_gt=model.max_gt)
    ev = OfflineEvaluator(model, batch_size=1)
    gk.LAUNCHES = 0
    preds, gts, _ = ev.run(ds)
    launches = gk.LAUNCHES
    head = model.pts_bbox_head
    n_boxes = min(300, head.num_query * head.num_classes)
    check(len(preds) == len(gts) == OFFLINE_SAMPLES, "offline: wrong count")
    for p in preds:
        check(p["bboxes"].shape == (n_boxes, 9) and p["valid"].shape == (n_boxes,),
              "offline: bad box shape")
        check(bool(np.isfinite(p["scores"]).all() and np.isfinite(p["bboxes"]).all()),
              "offline: non-finite scores or boxes")
    check(launches == 18 * OFFLINE_SAMPLES,
          f"offline: K1 launched {launches} times, expected {18 * OFFLINE_SAMPLES}")
    print(f"[12] offline, batch 1, {OFFLINE_SAMPLES} synthetic samples of "
          f"{model.num_frames} frames x {model.num_cams} cameras: K1 launches "
          f"{launches}; boxes finite, valid per sample "
          f"{[int(p['valid'].sum()) for p in preds]}")
    return launches


NUSC_CAMS = (("CAM_FRONT", 0.0), ("CAM_FRONT_RIGHT", -55.0),
             ("CAM_FRONT_LEFT", 55.0), ("CAM_BACK", 180.0),
             ("CAM_BACK_LEFT", 110.0), ("CAM_BACK_RIGHT", -110.0))
NUSC_SCENES, NUSC_SAMPLES = 4, 2


def write_nuscenes_split(root, name="nuscenes_infos_val_sweep.pkl"):
    """A split in the nuScenes info layout that the port's reader takes:
    NUSC_SCENES scenes of NUSC_SAMPLES keyframes 0.5 s apart, six cameras
    on the ego ring with JPEG images at 1600x900 and sensor2lidar
    extrinsics and intrinsics, two history sweeps per keyframe (the
    scene's earlier keyframes, or the first one), radar points per frame
    and ten GT boxes per keyframe, all from SEED. Returns the info path."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 20)
    H, W = 900, 1600
    y, x = np.mgrid[0:H, 0:W]
    K = np.array([[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]])

    def camera(yaw_deg, path, ts):
        yaw = np.deg2rad(yaw_deg)
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        R = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)  # camera axes
        return dict(data_path=str(path), timestamp=ts, sensor2lidar_rotation=R,
                    sensor2lidar_translation=np.array([0.0, 0.0, 1.6]),
                    cam_intrinsic=K)

    base = 1_533_151_603_547_590  # microseconds, a nuScenes-like epoch
    keyframes = []
    for s in range(NUSC_SCENES):
        for i in range(NUSC_SAMPLES):
            ts = base + 20_000_000 * s + 500_000 * i
            cams = {}
            for c, (name, yaw) in enumerate(NUSC_CAMS):
                shift = int(rng.integers(0, 256))
                img = np.stack([(x // 7 + shift) % 256, (y // 5 + 3 * c) % 256,
                                ((x // 40 + y // 40) % 2) * 200 + 20], -1)
                path = root / f"s{s}_k{i}_{name}.jpg"
                Image.fromarray(img.astype(np.uint8)).save(path, quality=90)
                cams[name] = camera(yaw, path, ts)
            radar = np.zeros((300, 7), np.float32)
            radar[:, 0:2] = rng.uniform(-50, 50, size=(300, 2))
            radar[:, 2] = rng.normal(0.5, 0.5, size=300)
            radar[:, 3:6] = rng.normal(size=(300, 3))
            gt = np.zeros((10, 9), np.float32)
            gt[:, 0:2] = rng.uniform(-40, 40, size=(10, 2))
            gt[:, 2] = rng.uniform(-1, 1, size=10)
            gt[:, 3:6] = rng.uniform(0.5, 5.0, size=(10, 3))
            gt[:, 6] = rng.uniform(-np.pi, np.pi, size=10)
            gt[:, 7:9] = rng.normal(size=(10, 2))
            keyframes.append(dict(
                token=f"s{s}k{i}", scene_token=f"scene-{s:04d}", timestamp=ts,
                cams=cams, radar_points=radar, gt_boxes=gt,
                gt_labels=rng.integers(0, 10, size=10),
                ego2lidar_xy=(0.0, 0.0)))
    for k, info in enumerate(keyframes):
        i = k % NUSC_SAMPLES
        history = [keyframes[k - j] for j in (1, 2) if i - j >= 0] or [info]
        info["sweeps_cam"] = [dict(cams=h["cams"], timestamp=h["timestamp"],
                                   radar_points=h["radar_points"])
                              for h in history]
    ann = root / name
    import pickle

    with open(ann, "wb") as f:
        pickle.dump({"infos": keyframes}, f)
    return ann


def phase_driver():
    """`python -m racformer_tpu_torch.eval` in process on the fabricated
    split, in the three protocols; single-stream and 4-stream predictions
    compared sample by sample."""
    import tempfile

    from racformer_tpu_torch.data import native
    from racformer_tpu_torch.eval.__main__ import main as eval_main
    from racformer_tpu_torch.ops import gather_kernel as gk

    n = NUSC_SCENES * NUSC_SAMPLES
    runs, total = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        ann = write_nuscenes_split(Path(tmp))
        print(f"[13] wrote {n} keyframes ({NUSC_SCENES} scenes x "
              f"{NUSC_SAMPLES}) x {len(NUSC_CAMS)} cameras of 1600x900 JPEG "
              f"in the nuScenes info layout")
        decode = (f"native libjpeg ({native.library_path()})"
                  if native.available() else
                  "PIL (the port's native library is not available: no g++ "
                  "or libjpeg)")
        print(f"[13] image decode path: {decode}")
        base = ["--config", str(CONFIG), "--override",
                f"data.val.ann_file={ann}"]
        for name, extra in (("--streaming --streams 4",
                             ["--streaming", "--streams", "4"]),
                            ("--streaming", ["--streaming"]),
                            ("offline", [])):
            gk.LAUNCHES = 0
            (preds, metrics), text = run_driver(eval_main, base + extra)
            launches = gk.LAUNCHES
            total += launches
            line = [l for l in text.splitlines() if l.startswith("eval:")]
            print(f"[13] eval driver {name}: {line[0] if line else 'no eval line'}"
                  f"; K1 launches {launches}; metrics "
                  f"{json.dumps({k: round(float(v), 4) for k, v in (metrics or {}).items() if isinstance(v, (int, float))})}")
            check(f"eval: {n} samples" in text and '"NDS"' in text,
                  f"eval driver {name}: no eval line or metrics")
            check(metrics is not None and all(
                np.isfinite(float(v)) for v in metrics.values()
                if isinstance(v, (int, float))), f"eval driver {name}: metrics")
            check(len(preds) == n and launches > 0 and all(
                np.isfinite(p["scores"]).all() and np.isfinite(p["bboxes"]).all()
                for p in preds), f"eval driver {name}: predictions")
            runs[name] = preds
    worst = d_box = 0.0
    compared, ok = 0, True
    for a, b in zip(runs["--streaming --streams 4"], runs["--streaming"]):
        good, d_score, k, e_box = decoded_match(a, b)
        ok, compared = ok and good, compared + k
        worst, d_box = max(worst, d_score), max(d_box, e_box)
    print(f"[13] 4 streams against one stream, sample by sample: decoded "
          f"scores max |d| {worst:.4g} (bound {SCORE_TOL}), {compared} boxes "
          f"matched, max |d| {d_box:.4g} (bound 0.1 max(1, |box|)) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "4-stream predictions disagree with single-stream ones")
    return total


DRIVER_OVERRIDES = ["synthetic_samples=4", "evaluation.interval=1",
                    "evaluation.max_samples=2", "log_interval=1"]


def run_driver(main, argv):
    """A driver's main(argv) in process; returns (its result, its stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def check_driver_steps(tag, res, want):
    """Every step of a train-driver run launched K1-K4 `want` times."""
    bad = [s for s in res["steps"] if tuple(s["launches"]) != want]
    seen = [tuple(s["launches"]) for s in res["steps"]]
    if len(seen) > 8:  # as counts: {launches: steps}
        seen = {k: seen.count(k) for k in dict.fromkeys(seen)}
    print(f"{tag}: launches per step (K1, K2, K3, K4) {seen}, expected {want}")
    check(res["steps"] and not bad, f"{tag}: steps launched {bad}")


def phase_train_driver(cfg):
    """`python -m racformer_tpu_torch.train` in process: a run, its resume,
    the eval driver on the work dir, and 2 steps on a nuScenes-layout
    training split. Returns the (K1, K2, K3, K4) launches of the phase."""
    import tempfile

    from racformer_tpu_torch.data import SyntheticDataset
    from racformer_tpu_torch.eval import OfflineEvaluator
    from racformer_tpu_torch.eval.__main__ import main as eval_main
    from racformer_tpu_torch.train.__main__ import main as train_main

    layers = int(cfg["decoder"]["num_layers"])
    accum = int(cfg.get("accumulate_steps", 1))
    want = (0, 2 * SITES * layers * accum, SITES * layers * accum,
            SITES * layers * accum)
    totals = np.zeros(4, np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp) / "wd"
        runs, outs = {}, {}
        for name, extra in (("A", ["--max-steps", "2"]),
                            ("B", ["--max-steps", "4", "--resume"])):
            reset_launch_counts()
            res, out = run_driver(train_main, [
                "--config", str(CONFIG), "--synthetic", "--work-dir", str(wd),
                "--ema", "--match-stats", *extra, "--override",
                *DRIVER_OVERRIDES])
            totals += launch_counts()
            runs[name], outs[name] = res, out
            check("training done" in out, f"run {name}: no 'training done'")
            saves = res["saves"]
            print(f"[14] run {name} ({' '.join(extra)} --ema --match-stats): "
                  f"steps {res['start_step'] + 1}..{res['last_step']}")
            for sv in saves:
                print(f"[14]   checkpoint step {sv['step']}: {sv['bytes']} B, "
                      f"attempts {sv['attempts']}, verified {sv['verified']}")
            for ev in res["evals"]:
                print(f"[14]   in-training eval @ {ev['step']}: "
                      f"{ev['samples']} samples offline, K1 launches "
                      f"{ev['k1_launches']}, NDS "
                      f"{ev.get('metrics', {}).get('NDS')}")
            check(saves and all(sv["verified"] for sv in saves),
                  f"run {name}: a checkpoint failed verification")
            check_driver_steps(f"[14] run {name}", res, want)
            check(all(ev["k1_launches"] == 18 * ev["samples"] > 0
                      for ev in res["evals"]) and len(res["evals"]) == 1,
                  f"run {name}: in-training eval K1 launches {res['evals']}")
            if name == "A":
                del res["model"]  # free run A's model before run B builds its own
        a, b = runs["A"], runs["B"]
        check("resumed from step 2" in outs["B"],
              "run B did not resume from step 2")
        same = b["restored_digest"] == a["digest"]
        print(f"[14] run B resumed from step 2: restored state digest "
              f"{b['restored_digest'][:16]} against run A's saved "
              f"{a['digest'][:16]}: {'bitwise equal' if same else 'DIFFER'}")
        check(same, "the restored state differs from the saved one")
        records = [json.loads(line) for line in
                   (wd / "metrics.jsonl").read_text().splitlines()]
        val = [r["step"] for r in records if r.get("phase") == "val"]
        train = [r["step"] for r in records if "phase" not in r]
        print(f"[14] metrics.jsonl: train records at steps {train}, val "
              f"records at steps {val}")
        check(train and val == [2, 4], "metrics.jsonl: records missing")
        best = json.loads((wd / "best" / "metrics.json").read_text())
        print(f"[14] best/metrics.json: step {best['step']}, NDS {best['NDS']}")
        check((wd / "best" / "checkpoints" / str(best["step"]) / "state.pth")
              .is_file(), "no best checkpoint")
        missing = [f"dec_{l}/match_epoch{e}" for l in range(layers)
                   for e in range(2) if not (wd / "match_stats" / f"dec_{l}"
                                             / "rank_0"
                                             / f"match_epoch{e}.json").is_file()]
        print(f"[14] match statistics: {layers} layers x 2 epochs, missing "
              f"{missing}")
        check(not missing, f"match statistics missing: {missing}")

        # the eval driver on the work dir against the in-memory model that
        # saved its checkpoint, with deterministic algorithms (index_add_
        # otherwise adds in the order its atomics land)
        model = b["model"].eval()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            reset_launch_counts()
            (preds, metrics), out = run_driver(eval_main, [
                "--config", str(CONFIG), "--synthetic", "--max-samples", "2",
                "--checkpoint", str(wd)])
            driver_k1 = launch_counts()[0]
            totals[0] += driver_k1
            ds = SyntheticDataset(
                num_samples=2, num_cams=model.num_cams,
                num_frames=model.num_frames, hw=model.image_hw,
                max_radar_points=cfg["radar"]["max_points"], max_gt=model.max_gt)
            ecfg = dict(cfg.get("eval_cfg", {}), legacy_version="v1.0.0")
            want_preds, _, _ = OfflineEvaluator(model, eval_cfg=ecfg).run(ds)
        finally:
            torch.use_deterministic_algorithms(False)
        exact = len(preds) == len(want_preds) == 2 and all(
            np.array_equal(p[k], w[k]) for p, w in zip(preds, want_preds)
            for k in w)
        print(f"[14] eval driver --checkpoint <work_dir>: "
              f"{[l for l in out.splitlines() if l.startswith(('restored', 'eval:'))]}"
              f"; K1 launches {driver_k1}; predictions against "
              f"the in-memory model's (deterministic algorithms): "
              f"{'bitwise equal' if exact else 'DIFFER'}")
        if not exact:
            close = all(decoded_match(p, w)[0] for p, w in zip(preds, want_preds))
            print(f"[14] not bitwise; within phase 5's bounds: {close}")
            check(close, "eval driver predictions disagree with the model's")
        check(driver_k1 == 18 * 2, f"eval driver: K1 launched {driver_k1}")
        del model, b, runs
        torch.cuda.empty_cache()

        # 2 steps on a nuScenes-layout training split
        ann = write_nuscenes_split(Path(tmp), "nuscenes_infos_train_sweep.pkl")
        reset_launch_counts()
        res, out = run_driver(train_main, [
            "--config", str(CONFIG), "--work-dir", str(Path(tmp) / "nusc"),
            "--max-steps", "2", "--override", f"data.train.ann_file={ann}",
            "evaluation.interval=0", "log_interval=1"])
        totals += launch_counts()
        check(res["last_step"] == 2, "nuScenes split: not 2 steps")
        check_driver_steps("[14] nuScenes split", res, want)
        rec = [json.loads(line) for line in
               (Path(tmp) / "nusc" / "metrics.jsonl").read_text().splitlines()]
        check(all(np.isfinite(r["loss_total"]) for r in rec),
              "nuScenes split: non-finite loss")
        del res
    return tuple(int(n) for n in totals)


TRAIN_STEPS = 5
SITES = 3  # sampling sites per decoder iteration: image, radar BEV, LSS BEV


def launch_counts():
    """(K1, K2, K3, K4) launch counters."""
    from racformer_tpu_torch.train.__main__ import launch_counts as counts

    return counts()


def reset_launch_counts():
    from racformer_tpu_torch.ops import gather_kernel as gk
    from racformer_tpu_torch.ops import scatter_kernel as sk

    gk.LAUNCHES = gk.GATHER_LAUNCHES = gk.CORNER_LAUNCHES = sk.LAUNCHES = 0


def train_site_cases(model, gen, dtype, dev):
    """(name, map, (row, x0p, wx, wy), cotangent, outside share) for the
    training path's three sampling sites at the model's shapes: one
    microbatch (B = 1), the matching queries plus the query-denoising
    ones."""
    from racformer_tpu_torch.nn.img_sampling import concat_geometry
    from racformer_tpu_torch.ops.bilinear import sampler_ready
    from racformer_tpu_torch.ops.deform_attn import bev_points
    from racformer_tpu_torch.ops.msmv import level_concat, level_points

    head = model.pts_bbox_head
    layer = head.transformer.decoder.decoder_layer
    T, N, G, L = model.num_frames, model.num_cams, model.num_groups, model.num_levels
    Q = head.num_query + head.dn_groups * head.max_gt
    c = model.embed_dims // G
    img = layer.sampling
    P = img.num_points * img.depth_num
    hws, roffs, rcat = concat_geometry(model.image_hw, L)
    S = T * G
    fmap = level_concat([torch.randn(S, N, h, w, c, generator=gen, device=dev)
                         .to(dtype) for h, w in hws])
    fmap = fmap.reshape(S, N * rcat, *fmap.shape[-2:])
    x, y, out = coords(gen, (S, Q, P), dev)
    view = torch.randint(0, N, (S, Q, P), generator=gen, device=dev)
    pts = level_points(x, y, view, hws, roffs, rcat, dtype)
    cases = [("image", fmap, pts, out.float().mean().item())]
    for name in ("radar_bev", "lss_bev"):
        bev = getattr(layer, f"sampling_{name}")
        H, W = bev.spatial_shape
        M = bev.num_heads
        Pb = bev.num_points * bev.depth_num
        vmap = sampler_ready(torch.randn(T, M, H, W, c, generator=gen, device=dev)
                             .to(dtype))
        R0 = vmap.shape[2]
        x, y, out = coords(gen, (T, Q, M, Pb), dev)
        cases.append((name, vmap.reshape(T, M * R0, *vmap.shape[3:]),
                      bev_points(x, y, (H, W), R0, dtype),
                      out.float().mean().item()))
    return [(name, fmap, pts, torch.randn(fmap.shape[0], pts[0].shape[1], c,
                                          generator=gen, device=dev).to(dtype),
             outside) for name, fmap, pts, outside in cases]


def map_grad_ok(got, want):
    """K3 against its plain version: (ok, tolerance). Both sum the same f32
    terms in another order and round once to the map dtype: f32 within 1e-5
    of max(1, max|ref|); bf16 and f16 within one step of each side's
    rounding, eps |ref| (2^-7 bf16, 2^-10 f16), plus 1e-5 max|ref| where
    the terms cancel."""
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    if want.dtype == torch.float32:
        return err.max().item() <= 1e-5 * max(1.0, top), "atol 1e-5 max(1, max|ref|)"
    eps = torch.finfo(want.dtype).eps
    return (bool((err <= eps * want.float().abs() + 1e-5 * top).all()),
            f"2^{int(np.log2(eps))} |ref| + 1e-5 max|ref|")


def largest_bucket(pts, R):
    """K3's bucketing (`bucket_by_row`) against its plain version: equal
    offsets and permutation (the bucketing is stable), each record with its
    point's inputs. Returns the largest bucket."""
    from racformer_tpu_torch.ops import scatter_kernel as sk

    row, x0p, wx, wy = pts
    offsets, records = sk.bucket_by_row(row, x0p, wx, wy, R)
    want_off, want_perm = sk.bucket_by_row_reference(row, R)
    p = want_perm.long()
    check(torch.equal(offsets, want_off) and torch.equal(records[:, 0], want_perm)
          and torch.equal(records[:, 1], x0p.reshape(-1)[p] + (row.reshape(-1)[p] << 16))
          and torch.equal(records[:, 2].view(torch.float32), wx.reshape(-1)[p])
          and torch.equal(records[:, 3].view(torch.float32), wy.reshape(-1)[p]),
          "K3's bucketing disagrees with bucket_by_row_reference")
    return int((want_off[1:] - want_off[:-1]).max().item())


def library_ms(fmap, pts, g):
    """One PyTorch call for each of K2, K3, K4's functions, timed, never
    used by the port: `F.grid_sample` and `aten.grid_sampler_2d_backward`
    (map gradient, then location gradient) on the un-fused zero-bordered
    NCHW map [S, C, R + 1, Wp] of the same slabs, rows, columns and C, at the
    same points (x = x0p + wx, y = row + wy, align_corners, zero padding).
    Returns {kernel: ms, or None where the call refuses the dtype}."""
    import torch.nn.functional as F

    S, R, Wp, C2 = fmap.shape
    C = C2 // 2
    row, x0p, wx, wy = pts
    nchw = torch.empty(S, C, R + 1, Wp, dtype=fmap.dtype, device=fmap.device)
    nchw[:, :, :R] = fmap[..., :C].permute(0, 3, 1, 2)
    nchw[:, :, R] = fmap[:, R - 1, :, C:].permute(0, 2, 1)
    x = x0p.float() + wx
    y = row.float() + wy
    grid = torch.stack([2 * x / (Wp - 1) - 1, 2 * y / R - 1], -1)[:, None]
    grid = grid.to(fmap.dtype)
    gout = g.permute(0, 2, 1)[:, :, None].contiguous()  # [S, C, 1, K]
    back = torch.ops.aten.grid_sampler_2d_backward
    calls = {
        "patch_gather": lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        "patch_scatter": lambda: back(gout, nchw, grid, 0, 0, True, [True, False]),
        "patch_corner_grads": lambda: back(gout, nchw, grid, 0, 0, True,
                                           [False, True]),
    }
    out = {}
    for name, fn in calls.items():
        try:
            out[name] = median_ms(fn, reps=5, warmup=1)
        except RuntimeError as e:  # a dtype the CUDA op does not take
            print(f"[7] library call for {name} refused {fmap.dtype}: "
                  f"{str(e).splitlines()[0]}")
            out[name] = None
    return out


def clustered(row, R, gen):
    """row with 90% of each slab's points moved into 5% of its rows."""
    S, K = row.shape
    hot = torch.stack([torch.randperm(R, generator=gen, device=row.device)
                       [:max(1, R // 20)] for _ in range(S)])
    pick = torch.randint(0, hot.shape[1], (S, K), generator=gen, device=row.device)
    move = torch.rand(S, K, generator=gen, device=row.device) < 0.9
    return torch.where(move, torch.gather(hot, 1, pick), row).to(torch.int32)


def patch_runs(fmap, pts, g):
    """{kernel: (kernel call, plain call)} for K2, K3 and K4 on one map,
    its points (row, x0p, wx, wy) and the cotangent g."""
    from racformer_tpu_torch.ops import gather_kernel as gk
    from racformer_tpu_torch.ops import scatter_kernel as sk

    shape = tuple(fmap.shape)
    return {
        "patch_gather": (lambda: gk.patch_gather(fmap, *pts),
                         lambda: gk.patch_gather_reference(fmap, *pts)),
        "patch_scatter": (lambda: sk.patch_scatter(g, *pts, shape),
                          lambda: sk.patch_scatter_reference(g, *pts, shape)),
        "patch_corner_grads": (
            lambda: gk.patch_corner_grads(fmap, g, *pts),
            lambda: gk.patch_corner_grads_reference(fmap, g, *pts)),
    }


def compare(kname, got, want, dtype, floor=1.0):
    """A K2, K3 or K4 result against its plain version's: (ok, max abs
    error, its printout, the tolerance). Where both sides compute in f32
    the error is held to 1e-5 max(floor, max|ref|), for K4 each output
    against its own max|ref|: floor 1 for phase 7's inputs of order one,
    0 for a train step's tiny location gradients."""
    atol = "1e-5 max|ref|" if floor == 0 else f"1e-5 max({floor:g}, max|ref|)"
    if kname == "patch_corner_grads":
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        tops = [b.abs().max().item() for b in want]
        # f32 arithmetic on both sides; the shuffles sum in another order
        ok = all(e <= 1e-5 * max(floor, t) for e, t in zip(errs, tops))
        detail = ", ".join(f"{n} {e:.3g} (max|ref| {t:.3g})"
                           for n, e, t in zip(("d_wx", "d_wy"), errs, tops))
        return ok, max(errs), detail, f"atol {atol} per output"
    check(got.dtype == dtype, f"{kname} returned {got.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    ref_max = want.float().abs().max().item()
    if kname == "patch_scatter":
        ok, tol = map_grad_ok(got, want)
    elif dtype != torch.float32:
        # K2: one bf16 or f16 rounding of the output in each version
        rtol = rounding_tol(dtype)
        ok = bool(((got.float() - want.float()).abs()
                   <= rtol * ref_max + rtol * want.float().abs()).all())
        tol = f"rtol {rtol:g} + atol {rtol:g} max|ref|"
    else:
        ok, tol = err <= 1e-5 * max(floor, ref_max), f"atol {atol}"
    return ok, err, f"{err:.3g}", tol


def gather_edge_cases(fmap, pts, g, gen):
    """K2 and K4 against their plain versions on the edges of their point
    tiling (csrc/point_tiles.cuh), on the image site's map: point counts
    that leave a ragged tile, points at the last column and the last row,
    every point touching the zero border, and clustered points."""
    S, R, Wp, _ = fmap.shape
    row, x0p, wx, wy = pts
    K, dev, dtype = row.shape[1], row.device, fmap.dtype
    idx = torch.arange(K, device=dev)
    # x0p = 0 reads columns 0-1, x0p = Wp - 2 columns Wp - 2 and Wp - 1: the
    # zero border on either side (PAD = 2 columns)
    border = torch.tensor([0, Wp - 2], dtype=torch.int32, device=dev)
    cases = {
        "K=1": (row[:, :1], x0p[:, :1], wx[:, :1], wy[:, :1], g[:, :1]),
        "K=33 (tile + 1)": (row[:, :33], x0p[:, :33], wx[:, :33], wy[:, :33],
                            g[:, :33]),
        "last column (x0p = Wp - 2) and last row (row = R - 1)": (
            torch.where(idx % 3 == 0, R - 1, row),
            torch.where(idx % 2 == 0, Wp - 2, x0p), wx, wy, g),
        "all outside (x0p in 0, Wp - 2: zero border)": (
            row, border[idx % 2].expand(S, K), wx, wy, g),
        "clustered (90% of the points in 5% of the rows)": (
            clustered(row, R, gen), x0p, wx, wy, g),
    }
    for case, (r, x, a, b, gg) in cases.items():
        hot = (r.to(torch.int32).contiguous(), x.to(torch.int32).contiguous(),
               a.contiguous(), b.contiguous())
        gg = gg.contiguous()
        runs = {k: v for k, v in patch_runs(fmap, hot, gg).items()
                if k != "patch_scatter"}
        for kname, (kern, plain) in runs.items():
            want = plain()
            if case.startswith("all outside"):
                check(all(not w.any() for w in (want if isinstance(want, tuple)
                                                else (want,))),
                      f"{kname}'s plain version is not zero on the zero border")
            ok, err, detail, tol = compare(kname, kern(), want, dtype)
            print(f"[7] {kname:18s} image, {case} {str(dtype):14s}: "
                  f"max_abs_err {detail} ({tol}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{kname} disagrees with its plain version: {case}, {dtype}")


def phase_patch_kernels(model, dev):
    """K2, K3, K4 against their plain versions, with their bounds and
    library calls; K3 also with its bucketing and a clustered case, K2 and
    K4 with the edge cases of `gather_edge_cases`. Returns {kernel: {err,
    ms, plain_ms, bound_ms, bound_by, library_ms}}, the times summed over the
    three sites with bf16 maps (the training path's dtype)."""
    from racformer_tpu_torch.ops import scatter_kernel as sk

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    stats = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=set(),
                     library_ms=0.0)
             for k in ("patch_gather", "patch_scatter", "patch_corner_grads")}
    for dtype in (torch.float32, torch.bfloat16):
        for name, fmap, pts, g, outside in train_site_cases(model, gen, dtype, dev):
            shape = tuple(fmap.shape)
            es = fmap.element_size()
            runs = patch_runs(fmap, pts, g)
            lib = library_ms(fmap, pts, g)
            for kname, (kern, plain) in runs.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                ok, err, detail, tol = compare(kname, got, want, dtype)
                extra = (f", largest bucket {largest_bucket(pts, shape[1])}"
                         if kname == "patch_scatter" else "")
                del got, want
                t_k = median_ms(kern, reps=10, warmup=2)
                t_p = median_ms(plain, reps=3, warmup=1)
                t_b, by = bound_ms(kname, shape, pts, es)
                t_l = lib[kname]
                print(f"[7] {kname:18s} {name:9s} {str(dtype):14s} map {shape} "
                      f"K={pts[0].shape[1]} outside={outside:.3f}: max_abs_err "
                      f"{detail} ({tol}) {'ok' if ok else 'FAIL'}; kernel "
                      f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {t_b:.4f} ms "
                      f"({by}), share {t_b / t_k:.3f}, library "
                      f"{'refused' if t_l is None else f'{t_l:.4f} ms'}{extra}")
                check(ok, f"{kname} disagrees with its plain version at {name} "
                          f"{dtype}")
                st = stats[kname]
                st["err"] = max(st["err"], err)
                if dtype == torch.bfloat16:
                    st["ms"] += t_k
                    st["plain_ms"] += t_p
                    st["bound_ms"] += t_b
                    st["bound_by"].add(by)
                    st["library_ms"] = (None if t_l is None or st["library_ms"] is None
                                        else st["library_ms"] + t_l)
            if name == "image":
                hot = (clustered(pts[0], shape[1], gen), *pts[1:])
                got = sk.patch_scatter(g, *hot, shape)
                want = sk.patch_scatter_reference(g, *hot, shape)
                ok, tol = map_grad_ok(got, want)
                err = (got.float() - want.float()).abs().max().item()
                del got, want
                print(f"[7] patch_scatter      image, clustered (90% of the points "
                      f"in 5% of the rows) {str(dtype):14s}: max_abs_err "
                      f"{err:.3g} ({tol}) {'ok' if ok else 'FAIL'}; largest "
                      f"bucket {largest_bucket(hot, shape[1])}")
                check(ok, f"patch_scatter disagrees with its plain version on "
                          f"clustered points, {dtype}")
                del hot
                gather_edge_cases(fmap, pts, g, gen)
            del runs
    for st in stats.values():
        st["bound_by"] = "/".join(sorted(st["bound_by"]))
    return stats


def finite_grads(model):
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())


def phase_train(cfg, dev):
    """The flagship train step, TRAIN_STEPS times."""
    from racformer_tpu_torch.train.__main__ import build, to_device

    model, opt, train_step, dataset, batch = build(cfg, dev, SEED, 1000)
    accum = int(cfg.get("accumulate_steps", 1))
    layers = int(cfg["decoder"]["num_layers"])
    print(f"[8] train model: {sum(p.numel() for p in model.parameters())} "
          f"parameters ({sum(p.numel() for p in opt.frozen().values())} "
          f"frozen), batch {batch} in {accum} microbatches, "
          f"{model.pts_bbox_head.num_query} + "
          f"{model.pts_bbox_head.dn_groups * model.max_gt} DN queries")
    batches = [to_device(dataset.batch(list(range(i * batch, (i + 1) * batch))),
                         dev) for i in range(TRAIN_STEPS + 1)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(SEED + 1)
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        metrics = train_step(batches[i], gen)
        losses = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in losses.values()),
              f"non-finite losses at step {i + 1}: {losses}")
        check(finite_grads(model), f"non-finite gradients at step {i + 1}")
    launches = launch_counts()
    per_step = [n // TRAIN_STEPS for n in launches]
    want = (0, 2 * SITES * layers * accum, SITES * layers * accum,
            SITES * layers * accum)
    print(f"[8] {TRAIN_STEPS} train steps: launches per step K1 {per_step[0]}, "
          f"K2 {per_step[1]}, K3 {per_step[2]}, K4 {per_step[3]} (expected "
          f"{want[0]}, {want[1]} = {SITES} sites x {layers} iterations x "
          f"{accum} microbatches x 2 (forward and checkpointed recompute), "
          f"{want[2]}, {want[3]})")
    check(tuple(per_step) == want and all(n % TRAIN_STEPS == 0 for n in launches),
          f"train launches {launches} over {TRAIN_STEPS} steps, expected "
          f"{want} per step")
    print(f"[8] last step's metrics: " + ", ".join(
        f"{k} {v:.5g}" for k, v in sorted(losses.items())))
    frozen = opt.frozen()
    moved = [n for n, p in model.named_parameters()
             if n not in frozen and not torch.equal(p, before[n])]
    still = [n for n, p in frozen.items() if torch.equal(p, before[n])]
    print(f"[8] parameters moved: {len(moved)} of {len(before) - len(frozen)} "
          f"trainable tensors; frozen tensors unchanged: {len(still)} of "
          f"{len(frozen)}")
    check(len(moved) == len(before) - len(frozen) and len(still) == len(frozen),
          "a trainable parameter did not move or a frozen one did")
    step_own_inputs(train_step, batches[-1], gen, timed=False)
    return model, batches[0], launches


def step_own_inputs(train_step, batch, gen, timed, tag="[8]"):
    """K2, K3 and K4 on their own inputs from one train step (each kernel's
    first call at each map shape), against their plain versions, with the
    statistics that set this work apart from phase 7's uniform points: the
    largest row bucket, the share of rows with points, the points in the
    busiest 1% of rows, the busiest column, and the share of the column
    reads that go to distinct columns (what the bound counts; the rest L2
    has to absorb); when `timed`, the kernel's ms and the bound."""
    from racformer_tpu_torch.ops import gather_kernel as gk
    from racformer_tpu_torch.ops import scatter_kernel as sk

    # kernel -> (its module, its plain version, the index of its first point
    # input; its first argument, the map or the cotangent, has the map dtype)
    spied = {"patch_gather": (gk, gk.patch_gather_reference, 1),
             "patch_scatter": (sk, sk.patch_scatter_reference, 1),
             "patch_corner_grads": (gk, gk.patch_corner_grads_reference, 2)}
    origs = {k: getattr(mod, k) for k, (mod, _, _) in spied.items()}
    caught = {k: {} for k in spied}

    def spy(kname):
        def call(*args):
            shape = tuple(args[-1] if kname == "patch_scatter" else args[0].shape)
            if shape not in caught[kname]:
                caught[kname][shape] = [a.clone() if torch.is_tensor(a) else a
                                        for a in args]
            return origs[kname](*args)
        return call

    for kname, (mod, _, _) in spied.items():
        setattr(mod, kname, spy(kname))
    try:
        train_step(batch, gen)
    finally:
        for kname, (mod, _, _) in spied.items():
            setattr(mod, kname, origs[kname])
    torch.cuda.synchronize()
    labels = {"patch_gather": "K2", "patch_scatter": "K3", "patch_corner_grads": "K4"}
    for kname, (_, plain, first) in spied.items():
        for shape, args in caught[kname].items():
            S, R, Wp, _ = shape
            pts = args[first:first + 4]
            row, x0p = pts[:2]
            dtype = args[0].dtype
            kern = functools.partial(origs[kname], *args)
            ok, err, detail, tol = compare(kname, kern(), plain(*args), dtype,
                                           floor=0.0)
            timing = ""
            if timed:
                t_k = median_ms(kern, reps=10, warmup=2)
                t_b, by = bound_ms(kname, shape, pts, args[0].element_size())
                timing = (f"; kernel {t_k:.4f} ms, bound {t_b:.4g} ms ({by}), "
                          f"share {t_b / t_k:.3g}")
            key = (torch.arange(S, device=row.device)[:, None] * R
                   + row.long()).reshape(-1)
            counts = torch.bincount(key, minlength=S * R).sort(descending=True).values
            cols = torch.bincount(x0p.reshape(-1).long(), minlength=Wp)
            n = key.numel()
            print(f"{tag} {labels[kname]} on the step's inputs, map {shape} "
                  f"K={row.shape[1]} {dtype}: max_abs_err {detail} ({tol}) "
                  f"{'ok' if ok else 'FAIL'}{timing}; distinct columns "
                  f"per column read {unique_columns(shape, row, x0p) / (2 * n):.3f}, "
                  f"largest bucket {counts[0].item()}, rows with points "
                  f"{(counts > 0).float().mean().item():.3f}, points in the busiest "
                  f"1% of rows {counts[:max(1, S * R // 100)].sum().item() / n:.3f}, "
                  f"busiest column {cols.argmax().item()} with "
                  f"{cols.max().item() / n:.3f} of the points")
            check(ok, f"{labels[kname]} disagrees with its plain version on the "
                      f"step's inputs {shape}")
        caught[kname].clear()


def grads_of(model, metrics, clip=35.0):
    """The step's gradients before the optimizer's clip."""
    scale = max(1.0, float(metrics["grad_norm"]) / clip)
    return {n: p.grad.detach().float() * scale
            for n, p in model.named_parameters() if p.grad is not None}


def compare_steps(tag, a, b, ga, gb):
    """Largest relative loss difference, smallest per-tensor cosine and the
    global relative gradient difference of two steps."""
    loss_rel = max(abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-6)
                   for k in b)
    cos, num, den = 1.0, 0.0, 0.0
    top = max(g.abs().max().item() for g in gb.values())
    for n, g in gb.items():
        num += (ga[n] - g).double().pow(2).sum().item()
        den += g.double().pow(2).sum().item()
        if g.abs().max().item() > 1e-6 * top:
            c = torch.nn.functional.cosine_similarity(
                ga[n].double().flatten(), g.double().flatten(), dim=0).item()
            cos = min(cos, c)
    rel = (num / max(den, 1e-30)) ** 0.5
    print(f"{tag} max relative loss difference {loss_rel:.3g}; gradients: "
          f"smallest per-tensor cosine {cos:.6f}, |g_a - g_b| / |g_b| {rel:.3g}")
    return loss_rel, cos, rel


def phase_train_reference(model, batch, cfg, dev):
    """One train step with the kernels and one with their plain versions
    (`force_reference()`), from equal weights, batch and draws, lr 0."""
    from racformer_tpu_torch.ops import gather_kernel as gk
    from racformer_tpu_torch.train import (Optimizer, make_draws,
                                           make_train_step, split_microbatches)

    accum = int(cfg.get("accumulate_steps", 1))
    opt = Optimizer(model.named_parameters(), base_lr=0.0)
    step = make_train_step(model, opt, dict(cfg.get("depth", {})), accum)
    gen = torch.Generator().manual_seed(SEED + 2)
    draws = [make_draws(model, m, gen) for m in split_microbatches(batch, accum)]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    a = step(batch, draws=draws)
    ga = grads_of(model, a)
    model.load_state_dict(state)
    before = launch_counts()
    with gk.force_reference():
        b = step(batch, draws=draws)
    check(launch_counts() == before, "force_reference() launched a kernel")
    gb = grads_of(model, b)
    model.load_state_dict(state)
    loss_rel, cos, rel = compare_steps(
        "[9] flagship train step, kernels vs plain versions:", a, b, ga, gb)
    # bf16 maps: both versions compute in f32 and round each gathered value
    # and each map gradient to bf16 once; K3 sums its terms in another order,
    # so some map-gradient elements round the other way, and that noise
    # passes through the bf16 trunk's backward
    check(loss_rel <= 1e-3 and cos >= 0.99 and rel <= 0.05,
          "train step with the kernels drifts from the plain versions "
          "(bound: losses 1e-3 relative, every gradient's cosine >= 0.99, "
          "global relative gradient difference <= 0.05)")


SMALL = dict(num_cams=2, num_frames=2, embed_dims=256, num_query=12,
             num_clusters=2, image_hw=(64, 128), depth_bins=16,
             bev_size=(32, 32), num_decoder_layers=2, max_gt=4,
             trunk_dtype=torch.float32, decoder={"gather_dtype": torch.float32})
SMALL_DEPTH = dict(d_lo=1.0, d_hi=65.0, num_bins=16, downsample=16)


def phase_train_small(dev):
    """A small f32 config's train step on the card and on the CPU."""
    from racformer_tpu_torch.data import SyntheticDataset
    from racformer_tpu_torch.model import RaCFormer, random_init_
    from racformer_tpu_torch.train import (Optimizer, make_draws,
                                           make_train_step, split_microbatches)

    tiny, depth = SMALL, SMALL_DEPTH
    cpu = random_init_(RaCFormer(**tiny), torch.Generator().manual_seed(SEED))
    gpu = RaCFormer(**tiny).to(dev)
    gpu.load_state_dict(cpu.state_dict())
    data = SyntheticDataset(num_samples=2, num_cams=2, num_frames=2,
                            hw=(64, 128), max_radar_points=64, max_gt=4,
                            seed=SEED)
    batch = {k: torch.from_numpy(v) for k, v in data.batch([0, 1]).items()}
    gen = torch.Generator().manual_seed(SEED + 3)
    draws = [make_draws(cpu, m, gen, dropout=False)
             for m in split_microbatches(batch, 2)]
    out = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        model.train()
        step = make_train_step(model, Optimizer(model.named_parameters(),
                                                base_lr=0.0), depth, 2)
        before = launch_counts()
        m = step({k: v.to(d) for k, v in batch.items()}, draws=draws)
        torch.cuda.synchronize()
        out.append((m, {n: g.cpu() for n, g in grads_of(model, m).items()},
                    [x - y for x, y in zip(launch_counts(), before)]))
    (mc, gc, _), (mg, gg, launched) = out
    loss_rel, cos, rel = compare_steps(
        "[10] small f32 train step, card (kernels) vs CPU (plain):", mg, mc,
        gg, gc)
    print(f"[10] card launches K1-K4: {launched} (expected [0, 24, 12, 12])")
    # f32 both ways, TF32 off; the sums run in other orders, which the
    # train-mode BatchNorm layers of this tiny batch amplify (see
    # tests/test_torch_train_step.py), so the gradients are held to their
    # direction
    check(launched == [0, 24, 12, 12] and loss_rel <= 1e-4 and cos >= 0.999,
          "small train step on the card disagrees with the CPU (bound: "
          "losses 1e-4 relative, every gradient's cosine >= 0.999)")


# --- phases 15-17: several processes, and the decoder's remat policies ----

TORCHRUN_S = 600  # each torchrun call's limit (its processes are killed after)
DDP_OVERRIDES = ["evaluation.interval=0", "log_interval=1"]


def torchrun(n):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={n}"]


def run_group(cmd, timeout=TORCHRUN_S):
    """cmd from the checkout's root, in a process group of its own that is
    killed whole when cmd ends or overruns `timeout`; returns (exit code,
    its output)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise SmokeFailure(f"{' '.join(cmd[:8])} ... overran {timeout} s:\n"
                           f"{out[-4000:]}")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return proc.returncode, out


def check_run(tag, rc, out):
    if rc != 0:
        print(out[-6000:])
    check(rc == 0, f"{tag}: exit code {rc}")


def small_batch(rows):
    """`rows` samples for SMALL: the port's SyntheticDataset with images of
    coarse colour blocks at a gain of their own per image (train-mode
    BatchNorm on images of noise turns rounding into noise, see
    tests/test_torch_train_step.py)."""
    from racformer_tpu_torch.data import SyntheticDataset

    b = SyntheticDataset(num_samples=rows, num_cams=2, num_frames=2,
                         hw=(64, 128), max_radar_points=64, max_gt=4,
                         seed=SEED).batch(list(range(rows)))
    rng = np.random.default_rng(SEED)
    shape = b["imgs"].shape
    blocks = rng.uniform(0, 255, shape[:3] + (2, 4, 3))
    b["imgs"] = ((0.7 * blocks.repeat(32, axis=3).repeat(32, axis=4)
                  + 0.3 * b["imgs"]) * rng.uniform(0.1, 1.0, shape[:3]
                                                    + (1, 1, 1))
                 ).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()
            if not isinstance(v, list) and k not in ("token", "scene",
                                                      "timestamp")}


def small_ddp_step(dev, rows):
    """One train step of SMALL (seeded weights, dropout off, the recipe's
    optimizer) on this rank's rows of a seeded global batch of `rows`,
    under DistributedDataParallel when a process group is up. Returns the
    losses, the gradients after the clip and the parameters after the
    step, on the host."""
    from racformer_tpu_torch.model import RaCFormer, random_init_
    from racformer_tpu_torch.train import Optimizer
    from racformer_tpu_torch.train import step as step_mod
    from racformer_tpu_torch.utils import distributed

    world, rank = distributed.world(), distributed.rank()
    model = random_init_(RaCFormer(**SMALL),
                         torch.Generator().manual_seed(SEED)).to(dev).train()
    ddp = None
    if torch.distributed.is_initialized():
        from torch.nn.parallel import DistributedDataParallel

        ddp = DistributedDataParallel(model, device_ids=[dev],
                                      broadcast_buffers=False)
        ddp.register_comm_hook(None, step_mod.sum_gradients)
    opt = Optimizer(model.named_parameters())
    local = rows // world
    batch = {k: v[rank * local:(rank + 1) * local].to(dev)
             for k, v in small_batch(rows).items()}
    gen = torch.Generator().manual_seed(SEED + 5)
    draws = [step_mod.make_draws(model, m, gen, dropout=False, world=world,
                                 rank=rank)
             for m in step_mod.split_microbatches(batch, 2)]
    metrics = step_mod.make_train_step(model, opt, SMALL_DEPTH, 2, ddp=ddp)(
        batch, draws=draws)
    return {"losses": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in
                       model.named_parameters()}}


def train_run(argv):
    """The train driver's main(argv) in this process. Returns the driver's
    result without the model and the predictions, with the BatchNorm
    all-reduces made."""
    from racformer_tpu_torch.nn import layers
    from racformer_tpu_torch.train import __main__ as drv

    layers.SYNCS = 0
    out = drv.main(argv)
    out = {k: v for k, v in out.items() if k not in ("model", "eval_preds")}
    out["bn_syncs"] = layers.SYNCS
    return out


def worker(argv):
    """`chip_smoke.py --worker KIND OUT JSON`, one process of a torchrun
    call. It joins the process group itself (NCCL, one card per rank),
    turns TF32 off as the parent does, and runs a driver once for each
    argument list of JSON, in turn. KIND "train": the train driver
    (`train_run`), then `small_ddp_step` on this rank's rows of a global
    batch of 2 per rank; KIND "eval": the eval driver, counting each run's
    K1 launches. The eval runs and the small step run under deterministic
    algorithms, as their references in the parent do. Saves the results to
    OUT/rank_<r>.pt."""
    from racformer_tpu_torch.ops import gather_kernel as gk
    from racformer_tpu_torch.utils import distributed, pin_float32_precision

    kind, out_dir, runs = argv[0], Path(argv[1]), json.loads(argv[2])
    pin_float32_precision()
    rank = int(os.environ["RANK"])
    dev = distributed.init("cuda")
    try:
        if kind == "train":
            result = {"runs": [train_run(args) for args in runs]}
            torch.use_deterministic_algorithms(True, warn_only=True)
            result["small"] = small_ddp_step(dev, 2 * distributed.world())
        else:
            from racformer_tpu_torch.eval.__main__ import main as eval_main

            torch.use_deterministic_algorithms(True, warn_only=True)
            result = []
            for args in runs:
                gk.LAUNCHES = 0
                preds, _ = eval_main(args)
                result.append({"preds": preds, "k1": gk.LAUNCHES})
    finally:
        distributed.shutdown()
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(result, out_dir / f"rank_{rank}.pt")


def run_workers(kind, n, out_dir, runs):
    """`--worker KIND` on `n` cards in one torchrun call; returns each
    rank's result and the call's output."""
    rc, out = run_group(torchrun(n) + [str(REPO / "chip_smoke.py"),
                                       "--worker", kind, str(out_dir),
                                       json.dumps(runs)])
    check_run(f"torchrun --worker {kind} on {n} cards", rc, out)
    return ([torch.load(Path(out_dir) / f"rank_{r}.pt", weights_only=False)
             for r in range(n)], out)


def phase_ddp_train(cfg, n):
    """Phase 15: the train driver under torchrun, one process on each of
    `n` cards, in one torchrun call: run A --max-steps 3, run B --resume
    to 4, then SMALL's step on the same ranks against one process. Returns
    the K1-K4 launches of the driver runs, summed over the ranks."""
    import tempfile

    from racformer_tpu_torch.train.__main__ import accumulation_steps

    layers = int(cfg["decoder"]["num_layers"])
    accum = accumulation_steps(int(cfg.get("accumulate_steps", 1)),
                               int(cfg.get("batch_size_per_chip", 2)))
    want = [0, 2 * SITES * layers * accum, SITES * layers * accum,
            SITES * layers * accum]
    totals = np.zeros(4, np.int64)
    runs = {"A": ["--max-steps", "3"], "B": ["--max-steps", "4", "--resume"]}
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp) / "wd"
        ranks, _ = run_workers("train", n, tmp, [
            ["--distributed", "--synthetic", "--config", str(CONFIG),
             "--work-dir", str(wd), *extra, "--override", *DDP_OVERRIDES]
            for extra in runs.values()])
        steps = [r["step"] for r in map(json.loads, (wd / "metrics.jsonl")
                                        .read_text().splitlines())]
    print(f"[15] one torchrun call, --nproc_per_node={n}: runs A and B and "
          f"SMALL's step")
    a, b = [[r["runs"][i] for r in ranks] for i in range(2)]
    for (name, extra), sums in zip(runs.items(), (a, b)):
        gb = sums[0]["global_batch"]
        print(f"[15] run {name} ({' '.join(extra)}): world "
              f"{sums[0]['world']}, global batch {gb} ({gb // n} per rank "
              f"in {accum} microbatches)")
        for r, s in enumerate(sums):
            print(f"[15]   rank {r}: launches per step "
                  f"{[st['launches'] for st in s['steps']]}, BatchNorm "
                  f"all-reduces per microbatch "
                  f"{s['bn_syncs'] / (len(s['steps']) * accum):g}")
            bad = [st for st in s["steps"] if st["launches"] != want]
            check(s["steps"] and not bad,
                  f"run {name} rank {r}: launches {bad}, want {want}")
            totals += np.sum([st["launches"] for st in s["steps"]], axis=0)
        check(sums[0]["saves"] and all(sv["verified"]
                                       for sv in sums[0]["saves"]),
              f"run {name}: rank 0's checkpoint not verified")
        check(all(not s["saves"] for s in sums[1:]),
              f"run {name}: a rank other than 0 saved")
    digests = [s["restored_digest"] for s in b]
    same = digests == [a[0]["digest"]] * n
    print(f"[15] run B on {n} ranks restored digests "
          f"{[d[:16] for d in digests]} against run A's saved "
          f"{a[0]['digest'][:16]}: {'all equal' if same else 'DIFFER'}")
    check(same, "a rank restored another state than the saved one")
    print(f"[15] metrics.jsonl (rank 0 alone writes it): records at steps "
          f"{steps}")
    check(steps and len(steps) == len(set(steps)),
          "metrics.jsonl: missing or duplicated records")
    # SMALL on the same ranks against one process at the same global batch
    rows = 2 * n
    small = [r["small"] for r in ranks]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one = small_ddp_step(torch.device("cuda", 0), rows)
    finally:
        torch.use_deterministic_algorithms(False)
    loss_rel = max(abs(r["losses"][k] - v) / max(abs(v), 1e-12)
                   for r in small for k, v in one["losses"].items())
    p_err = max(float((r["params"][k] - v).abs().max())
                / max(float(v.abs().max()), 1e-30)
                for r in small for k, v in one["params"].items())
    _, cos, rel = compare_steps(
        f"[15] small f32 step, {n} ranks (global batch {rows}) against one "
        f"process:", small[0]["losses"], one["losses"], small[0]["grads"],
        one["grads"])
    print(f"[15] first-step losses max relative difference {loss_rel:.3g} "
          f"(bound 1e-5); parameters after the step max |d| / max|p| "
          f"{p_err:.3g} (bound 1e-4 at world 1)")
    check(loss_rel <= 1e-5, "DDP step losses disagree with one process")
    if n == 1:
        check(p_err <= 1e-4, "DDP step parameters disagree with one process")
    else:
        # rounding in BatchNorm's statistics moves gradients near zero, so a
        # first AdamW step (lr * sign(g)) can flip there: held by direction
        check(cos >= 0.999 and rel <= 1e-3,
              "DDP step gradients disagree with one process (bound: every "
              "gradient's cosine >= 0.999, global relative difference "
              "<= 1e-3)")
    return tuple(int(x) for x in totals)


# the eval driver's line after a protocol's run
EVAL_LINE = re.compile(r"^eval: \d+ samples, [\d.]+ samples/s", re.M)


def phase_ddp_eval(n):
    """Phase 16: the eval driver under torchrun on `n` cards (offline,
    --streaming --streams 4, in one torchrun call) on the synthetic split
    against the same driver in one process, both under deterministic
    algorithms. Returns the K1 launches, summed over the ranks."""
    import tempfile

    from racformer_tpu_torch.eval.__main__ import main as eval_main
    from racformer_tpu_torch.ops import gather_kernel as gk

    protocols = {"offline": ["--max-samples", "8"],
                 "--streaming --streams 4": ["--max-samples", "8",
                                             "--streaming", "--streams", "4"]}
    argvs = [["--config", str(CONFIG), "--synthetic", *extra]
             for extra in protocols.values()]
    with tempfile.TemporaryDirectory() as tmp:
        ranks, out = run_workers("eval", n, tmp, argvs)
    lines = EVAL_LINE.findall(out)
    check(len(lines) == len(argvs),
          f"rank 0 printed {len(lines)} eval lines, want {len(argvs)}")
    print(f"[16] one torchrun call, --nproc_per_node={n}: both protocols on "
          f"8 synthetic samples")
    k1 = 0
    for i, (name, args) in enumerate(zip(protocols, argvs)):
        runs = [r[i] for r in ranks]
        k1 += sum(r["k1"] for r in runs)
        print(f"[16] eval driver {name} on {n} ranks (deterministic "
              f"algorithms): K1 launches per rank {[r['k1'] for r in runs]}")
        check(all(r["k1"] > 0 for r in runs),
              f"{name}: a rank launched no K1")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            gk.LAUNCHES = 0
            (want, _), text = run_driver(eval_main, args)
        finally:
            torch.use_deterministic_algorithms(False)
        check(EVAL_LINE.search(text), "the eval driver printed no eval line")
        got = runs[0]["preds"]
        exact = len(got) == len(want) and all(
            np.array_equal(p[k], w[k]) for p, w in zip(got, want) for k in w)
        close = len(got) == len(want) and all(
            decoded_match(p, w)[0] for p, w in zip(got, want))
        print(f"[16] gathered predictions against one process's: "
              f"{'bitwise equal' if exact else 'not bitwise'}; within phase "
              f"5's bounds: {close}")
        check(exact if n == 1 else close,
              f"{name}: {n}-rank predictions disagree with one process "
              f"(bound: bitwise at world 1, phase 5's at more ranks)")
    return k1


# the sampler sites whose K2 gathers each policy runs again in the backward
REMAT_RECOMPUTED = {"full": 3, "dots": 3, "dots_no_batch": 3,
                    "save_sampled": 0, "save_bev": 1}


def phase_remat(cfg, dev):
    """Phase 17: each decoder remat policy for 2 flagship train steps with
    the same batches and draws, on one model built once: before each
    policy its decoder's `remat_policy` is set and the seeded weights and
    the optimizer's first state are restored. Returns the K2-K4 launches
    of the phase."""
    import copy

    from racformer_tpu_torch.nn.decoder import RaCFormerDecoder
    from racformer_tpu_torch.train import make_draws, split_microbatches
    from racformer_tpu_torch.train.__main__ import build, to_device

    accum = int(cfg.get("accumulate_steps", 1))
    layers = int(cfg["decoder"]["num_layers"])
    print("[17] building the flagship model once for the five policies")
    model, optimizer, step, dataset, batch = build(cfg, dev, SEED, 1000)
    decoder = next(m for m in model.modules()
                   if isinstance(m, RaCFormerDecoder))
    # on the host, so that the copy takes no device memory from the policies
    weights = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    opt_state = copy.deepcopy(optimizer.state_dict())
    batches = [to_device(dataset.batch(list(range(i * batch,
                                                 (i + 1) * batch))), dev)
               for i in range(2)]
    gen = torch.Generator().manual_seed(SEED + 7)
    draws = [[make_draws(model, m, gen)
              for m in split_microbatches(b, accum)] for b in batches]
    results, totals = {}, np.zeros(4, np.int64)
    for policy, again in REMAT_RECOMPUTED.items():
        k2 = (SITES + again) * layers * accum
        decoder.remat_policy = policy
        model.load_state_dict(weights)
        optimizer.load_state_dict(copy.deepcopy(opt_state))
        reset_launch_counts()
        for b, d in zip(batches, draws):
            metrics = step(b, draws=d)
            if not results.get(policy):  # step 1, from the seeded weights
                results[policy] = (
                    {k: float(v) for k, v in metrics.items()},
                    {n: g.cpu() for n, g in grads_of(model, metrics).items()})
        launches = launch_counts()
        totals += launches
        per_step = [x // 2 for x in launches]
        print(f"[17] policy {policy}: launches per step K1-K4 {per_step} (K2 "
              f"expected {k2})")
        per_site = SITES * layers * accum
        check(per_step == [0, k2, per_site, per_site]
              and all(x % 2 == 0 for x in launches),
              f"policy {policy}: launches {launches} over 2 steps")
    del model, step, metrics, batches
    torch.cuda.empty_cache()
    full_m, full_g = results["full"]
    for policy, (m, g) in results.items():
        if policy == "full":
            continue
        # step 1 from equal weights: after it, AdamW's lr * sign(g) turns
        # the rounding of near-zero gradients into differences of 2 lr
        loss_rel, cos, rel = compare_steps(
            f"[17] policy {policy} against full, step 1:", m, full_m, g, full_g)
        check(loss_rel <= 1e-3 and cos >= 0.99 and rel <= 0.05,
              f"policy {policy}: gradients disagree with full's (phase 9's "
              f"bound)")
    return tuple(int(x) for x in totals)


VOD_CONFIG = REPO / "racformer_tpu_torch" / "configs" / "racformer_vod.py"
VOD_SAMPLES = 8  # one epoch of 4 train steps at the config's batch 2
# the VoD smoke's epochs here: 10 of the original's 40 (60 of its 240
# steps, ~1 s each on the card; the tool's CLI runs all 40); the loss's
# fifths are means over 12 steps each
SMOKE_EPOCHS = 10
VOD_HW = (1216, 1936)  # the VoD camera's images, native
# the VoD camera's P2 at its native size (the dataset's calibration,
# rounded); the reader scales it with the images
VOD_P2 = np.array([[1495.5, 0.0, 961.3, 0.0], [0.0, 1495.5, 624.9, 0.0],
                   [0.0, 0.0, 1.0, 0.0]])
# radar (x forward, y left, z up) to camera (x right, y down, z forward),
# the radar 0.5 m below and 0.2 m behind the camera
VOD_TR = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, -0.5],
                   [1.0, 0.0, 0.0, 0.2], [0.0, 0.0, 0.0, 1.0]])


def write_vod_split(root):
    """A split in the KITTI-format VoD layout that the port's reader takes:
    VOD_SAMPLES frames, each a JPEG at VoD's native 1936x1216 with its
    camera's P2 at that size (so the reader resizes it to the model's
    256x704 and scales P2, as on real data) and a radar-to-camera
    Tr_velo_to_cam, a radar .bin of 400-1200 5-sweep points in the radar
    frame (float32 rows of x, y, z, RCS, v_r, v_r_comp, time; the config
    keeps 1024) and 4-16 GT boxes of the three classes and DontCare in the
    camera frame, as KITTI labels are; all from SEED. Returns the info
    path."""
    import pickle

    from PIL import Image

    rng = np.random.default_rng(SEED + 30)
    H, W = VOD_HW
    y, x = np.mgrid[0:H, 0:W]
    names = np.array(["Car", "Pedestrian", "Cyclist", "DontCare"])
    dims = np.array([[4.0, 1.6, 1.9], [0.7, 1.8, 0.7], [1.8, 1.7, 0.6],
                     [1.0, 1.0, 1.0]], np.float32)  # l, h, w
    infos = []
    for i in range(VOD_SAMPLES):
        shift = int(rng.integers(0, 256))
        img = np.stack([(x // 9 + shift) % 256, (y // 6 + 40 * i) % 256,
                        ((x // 50 + y // 50) % 2) * 180 + 30], -1)
        image = root / f"{i:05d}.jpg"
        Image.fromarray(img.astype(np.uint8)).save(image, quality=90)
        n = int(rng.integers(400, 1200))
        radar = np.zeros((n, 7), np.float32)
        radar[:, 0] = rng.uniform(3, 50, n)  # x forward
        radar[:, 1] = rng.uniform(-20, 20, n)  # y left
        radar[:, 2] = rng.uniform(-1.5, 1.5, n)  # z up
        radar[:, 3] = rng.normal(0, 10, n)  # RCS
        radar[:, 4:6] = rng.normal(0, 3, (n, 2))  # v_r, v_r_comp
        radar[:, 6] = rng.integers(-4, 1, n)  # sweep
        path = root / f"{i:05d}.bin"
        radar.tofile(path)
        k = int(rng.integers(4, 17))
        cls = rng.integers(0, 4, k)
        infos.append(dict(
            image=dict(image_idx=i, image_path=str(image)),
            calib=dict(P2=VOD_P2, Tr_velo_to_cam=VOD_TR, R0_rect=np.eye(4)),
            radar_path=str(path),
            annos=dict(
                name=names[cls],
                location=np.stack([rng.uniform(-15, 15, k), np.full(k, 1.5),
                                   rng.uniform(5, 45, k)], 1).astype(np.float32),
                dimensions=dims[cls] * rng.uniform(0.9, 1.1, (k, 3)).astype(
                    np.float32),
                rotation_y=rng.uniform(-np.pi, np.pi, k).astype(np.float32))))
    ann = root / "vod_infos.pkl"
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    return ann


def phase_vod(dev):
    """Phase 18: the VoD config unreduced through both drivers on a VoD-layout
    split, K1-K4 on a VoD step's own inputs, timed, and the VoD smoke.
    Returns the (K1, K2, K3, K4) launches of the drivers' runs."""
    import tempfile

    from racformer_tpu_torch.config import Config
    from racformer_tpu_torch.data.vod import VoDDataset
    from racformer_tpu_torch.eval import StreamingEvaluator
    from racformer_tpu_torch.eval.__main__ import main as eval_main
    from racformer_tpu_torch.eval.streaming import (prepare_frame,
                                                    radar_maps_are_columns)
    from racformer_tpu_torch.model import RaCFormer, config_kwargs, random_init_
    from racformer_tpu_torch.tools import vod_smoke
    from racformer_tpu_torch.train.__main__ import build, to_device
    from racformer_tpu_torch.train.__main__ import main as train_main

    cfg = Config.fromfile(str(VOD_CONFIG))
    kwargs = config_kwargs(cfg)
    layers = int(cfg["decoder"]["num_layers"])
    accum = int(cfg["accumulate_steps"])
    batch = int(cfg["batch_size_per_chip"])
    # counted from the code as for the flagship (phases 4 and 8): neither
    # count depends on cameras or frames
    per_sample = SITES * layers
    want = (0, 2 * SITES * layers * accum, SITES * layers * accum,
            SITES * layers * accum)
    print(f"[18] {VOD_CONFIG.relative_to(REPO)}: {kwargs['num_cams']} camera, "
          f"{kwargs['num_frames']} frame, {kwargs['image_hw']}, "
          f"Q={kwargs['num_query']}, C={kwargs['embed_dims']}, {layers} "
          f"layers, {kwargs['num_classes']} classes, batch {batch} in {accum} "
          f"microbatches; expected launches: K1 {per_sample} per eval sample "
          f"(offline, one stream) and per 4-stream step, per train step K2 "
          f"{want[1]}, K3 {want[2]}, K4 {want[3]}")
    totals = np.zeros(4, np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        ann = write_vod_split(Path(tmp))
        print(f"[18] wrote {VOD_SAMPLES} VoD-layout frames (1936x1216 JPEG, "
              f"radar .bin, KITTI infos)")
        data = [f"data.train.ann_file={ann}", f"data.val.ann_file={ann}"]

        # the train driver: one epoch of 4 steps, its checkpoint, and an
        # in-training KITTI eval that saves the best by mAP3D_all
        wd = Path(tmp) / "wd"
        reset_launch_counts()
        res, out = run_driver(train_main, [
            "--config", str(VOD_CONFIG), "--device", dev.type, "--work-dir",
            str(wd), "--max-steps",
            str(VOD_SAMPLES // batch), "--override", *data,
            "evaluation.interval=1", "evaluation.max_samples=4",
            "log_interval=1"])
        totals += launch_counts()
        check("training done" in out, "VoD train driver: no 'training done'")
        for sv in res["saves"]:
            print(f"[18] checkpoint step {sv['step']}: {sv['bytes']} B, "
                  f"verified {sv['verified']}")
        for ev in res["evals"]:
            print(f"[18] in-training KITTI eval @ {ev['step']}: "
                  f"{ev['samples']} samples offline, K1 launches "
                  f"{ev['k1_launches']}, mAP3D_all "
                  f"{ev.get('metrics', {}).get('mAP3D_all')}")
        check(res["saves"] and all(sv["verified"] for sv in res["saves"]),
              "VoD train driver: a checkpoint failed verification")
        check_driver_steps("[18] VoD train driver", res, want)
        check(len(res["evals"]) == 1 and res["evals"][0]["k1_launches"]
              == per_sample * res["evals"][0]["samples"] == per_sample * 4,
              f"VoD in-training eval: {res['evals']}")
        records = [json.loads(line) for line in
                   (wd / "metrics.jsonl").read_text().splitlines()]
        check(all(np.isfinite(r["loss_total"]) for r in records
                  if "loss_total" in r), "VoD train driver: non-finite loss")
        best = json.loads((wd / "best" / "metrics.json").read_text())
        print(f"[18] best/metrics.json: step {best['step']}, mAP3D_all "
              f"{best['mAP3D_all']}")
        check(np.isfinite(best["mAP3D_all"]) and (
            wd / "best" / "checkpoints" / str(best["step"]) / "state.pth")
            .is_file(), "VoD: no best checkpoint by mAP3D_all")
        del res
        torch.cuda.empty_cache()

        # the eval driver on the work dir in the three protocols
        runs = {}
        n_steps = {"offline": VOD_SAMPLES, "--streaming": VOD_SAMPLES,
                   "--streaming --streams 4": -(-VOD_SAMPLES // 4)}
        for name, extra in (("offline", []), ("--streaming", ["--streaming"]),
                            ("--streaming --streams 4",
                             ["--streaming", "--streams", "4"])):
            reset_launch_counts()
            (preds, metrics), text = run_driver(eval_main, [
                "--config", str(VOD_CONFIG), "--device", dev.type,
                "--checkpoint", str(wd), *extra, "--override", *data])
            counts = launch_counts()
            totals += counts
            line = [l for l in text.splitlines() if l.startswith("eval:")]
            scalars = {k: round(float(v), 4) for k, v in (metrics or {}).items()
                       if isinstance(v, (int, float))}
            print(f"[18] eval driver {name}: {line[0] if line else 'no eval line'}"
                  f"; K1 launches {counts[0]} "
                  f"(expected {per_sample * n_steps[name]}); mAP3D_all "
                  f"{scalars.get('mAP3D_all')}, mAP3D_corridor "
                  f"{scalars.get('mAP3D_corridor')}")
            check(f"eval: {VOD_SAMPLES} samples" in text and metrics
                  and np.isfinite(metrics["mAP3D_all"]),
                  f"VoD eval driver {name}: no eval line or KITTI metrics")
            check(counts == (per_sample * n_steps[name], 0, 0, 0),
                  f"VoD eval driver {name}: launches {counts}")
            check(len(preds) == VOD_SAMPLES and all(
                np.isfinite(p["scores"]).all() and np.isfinite(p["bboxes"]).all()
                for p in preds), f"VoD eval driver {name}: predictions")
            runs[name] = preds
        ok, worst, compared = True, 0.0, 0
        for a, b in zip(runs["--streaming --streams 4"], runs["--streaming"]):
            good, d_score, k, _ = decoded_match(a, b)
            ok, worst, compared = ok and good, max(worst, d_score), compared + k
        print(f"[18] 4 streams against one stream, sample by sample: decoded "
              f"scores max |d| {worst:.4g} (bound {SCORE_TOL}), {compared} "
              f"boxes matched {'ok' if ok else 'FAIL'}")
        check(ok, "VoD: 4-stream predictions disagree with single-stream ones")

        # K1 on a VoD eval step's own inputs
        with torch.device(dev):
            model = RaCFormer(**kwargs)
        random_init_(model, torch.Generator().manual_seed(SEED)).eval()
        ds = VoDDataset(str(ann), image_hw=model.image_hw,
                        max_radar_points=cfg["radar"]["max_points"],
                        max_gt=model.max_gt)
        cols = radar_maps_are_columns(ds[0])
        frames = [prepare_frame(ds[i], 0.5 * i, cols) for i in range(3)]
        ev = StreamingEvaluator(model)
        with torch.no_grad():
            for frame in frames[:2]:
                ev.step(frame)
            seen, caught = capture_fold_inputs(
                lambda: ev.step(frames[2], blocking=False))
            print(f"[18] eval step (one stream): in-view share of image sample "
                  f"points per iteration: {', '.join(f'{v:.3f}' for v in seen)}")
            check(min(seen) > 0.02, "VoD: image sample points never in view")
            step_fold_inputs(caught, "[18]", timed=True)
        del ev, model, caught
        torch.cuda.empty_cache()

        # K2-K4 on a VoD train step's own inputs, after 3 steps
        tcfg = Config.fromfile(str(VOD_CONFIG)).merge_override(data)
        model, _, train_step, dataset, batch = build(tcfg, dev, SEED, 1000,
                                                     synthetic=False)
        check(isinstance(dataset, VoDDataset), "VoD: the build's dataset")
        batches = [to_device(dataset.batch([2 * i, 2 * i + 1]), dev)
                   for i in range(4)]
        gen = torch.Generator().manual_seed(SEED + 1)
        for b in batches[:3]:
            train_step(b, gen)
        step_own_inputs(train_step, batches[3], gen, timed=True, tag="[18]")
        del model, train_step, dataset, batches
        torch.cuda.empty_cache()

    # the VoD smoke: the original's fixture, tiny widths and schedule
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        res, records, smoke = vod_smoke.run(tmp, dev.type, SMOKE_EPOCHS)
        counts = launch_counts()
        totals += counts
        steps = smoke["train1"]["steps"]
        first, last = vod_smoke.fifths(records)
        bad = vod_smoke.nonfinite_steps(records)
        norms = [r["grad_norm"] for r in records]
        print(f"[18] VoD smoke ({len(steps)} steps at batch 8): loss every "
              f"10th step "
              f"{[round(r['loss_total'], 4) for r in records[::10]]}; mean of "
              f"the first fifth {first:.4f} -> the last fifth {last:.4f} "
              f"({len(records) // 5} steps each); mAP3D_all "
              f"untrained {res['untrained']['mAP3D_all']} -> trained "
              f"{res['trained']['mAP3D_all']}, mAP3D_corridor "
              f"{res['untrained']['mAP3D_corridor']} -> "
              f"{res['trained']['mAP3D_corridor']}; in-training eval "
              f"{[(r['step'], r.get('mAP3D_all')) for r in res['in_training_eval']]}"
              f"; grad_norm over {len(norms)} steps: non-finite at {bad}, "
              f"median {statistics.median(norms):.2f}, max {max(norms):.2f}; "
              f"launches {counts}")
        smoke_want = (0, 2 * SITES * layers, SITES * layers, SITES * layers)
        check_driver_steps("[18] VoD smoke", smoke["train1"], smoke_want)
        check(len(records) == len(steps) and not bad,
              f"VoD smoke: {len(records)} of {len(steps)} steps' metrics, "
              f"non-finite grad_norm at the steps {bad}")
        check(last < first, f"VoD smoke: the loss did not fall ({first} -> "
                            f"{last})")
        smoke_kernels(Path(tmp) / "data" / "vod_infos.pkl",
                      write_vod_split(Path(tmp)), dev)
    return tuple(int(n) for n in totals)


def smoke_kernels(pkl, vod_ann, dev):
    """K1-K4 at the VoD smoke's widths (embed_dims 64: 16 channels per
    group, C = 16 for K1 and 2C = 32 for K2-K4, where the full-width sites
    have 64 and 128) on its fixture's own inputs: one train step of the
    model that the smoke's train driver builds (batch 8, one microbatch)
    for K2-K4 at each map shape, then one eval step of that model for K1
    at each site, each against its plain version.
    The fixture's calibration is the identity, so its eval step's image
    sample points all fall outside the image (K1's image site is all
    zero border); one more eval step of the same model on a frame of
    `vod_ann` (phase 18's split, a radar-to-camera Tr) puts them in view."""
    from racformer_tpu_torch.config import Config
    from racformer_tpu_torch.data.vod import VoDDataset
    from racformer_tpu_torch.eval import StreamingEvaluator
    from racformer_tpu_torch.eval.streaming import (prepare_frame,
                                                    radar_maps_are_columns)
    from racformer_tpu_torch.tools import vod_smoke
    from racformer_tpu_torch.train.__main__ import build, to_device

    cfg = Config.fromfile(str(VOD_CONFIG)).merge_override(
        vod_smoke.tiny_overrides(str(pkl)))
    model, _, train_step, dataset, batch = build(cfg, dev, SEED,
                                                 synthetic=False)
    print(f"[18] the smoke's model: C={model.embed_dims}, "
          f"Q={cfg['model']['num_query']}, {model.image_hw}, batch {batch}")
    sample = to_device(dataset.batch(list(range(batch))), dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    step_own_inputs(train_step, sample, gen, timed=False, tag="[18] smoke")
    model.eval()
    for name, ann in (("fixture", pkl), ("split", vod_ann)):
        ds = VoDDataset(str(ann), image_hw=model.image_hw,
                        max_radar_points=cfg["radar"]["max_points"],
                        max_gt=model.max_gt)
        cols = radar_maps_are_columns(ds[0])
        frames = [prepare_frame(ds[i], 0.5 * i, cols) for i in range(2)]
        ev = StreamingEvaluator(model)
        with torch.no_grad():
            ev.step(frames[0])
            seen, caught = capture_fold_inputs(
                lambda: ev.step(frames[1], blocking=False))
        print(f"[18] smoke eval step on the {name}'s frame: in-view share of "
              f"image sample points per iteration: "
              f"{', '.join(f'{v:.3f}' for v in seen)}")
        if name == "split":
            check(min(seen) > 0.02, "the smoke's model on the split's frame: "
                                    "image sample points never in view")
        step_fold_inputs(caught, f"[18] smoke, {name}", timed=False)
        del ev, caught
    del model, train_step, dataset
    torch.cuda.empty_cache()


HEAD_STEPS = 5  # phase 19's streaming steps per head
VOV_INPUT = (6, 256, 704, 3)  # the flagship's per-frame trunk input


def seeded_he_init_(module, generator):
    """He-normal convolution and linear weights, drawn from `generator`, so
    that a deep random net's activations keep their scale."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               .to(m.weight.device) * (2.0 / fan_in) ** 0.5)
    return module


def head_steps(model, frames, tag):
    """HEAD_STEPS streaming steps of `model` on `frames`, each checked
    finite: (evaluator, the launches)."""
    from racformer_tpu_torch.eval import StreamingEvaluator

    ev = StreamingEvaluator(model)
    reset_launch_counts()
    for f in frames[:HEAD_STEPS]:
        out = ev.step(f, blocking=False)
        check(bool(torch.isfinite(out["scores"]).all())
              and bool(torch.isfinite(out["bboxes"]).all()),
              f"{tag}: non-finite scores or boxes")
    return ev, launch_counts()


def phase_head_dtype(cfg, dev):
    """Phase 19: the bf16 decoder / head (`model.head_dtype=bfloat16`) on
    the flagship's streaming eval step and train step, the eval step
    through the unfolded samplers (`model.fused_gather=False`), and VoVNet
    V-99-eSE and the BEV nets. Returns the (K1, K2, K3, K4) launches of its
    runs (not of its comparisons)."""
    import copy

    from racformer_tpu_torch.model import RaCFormer, config_kwargs, random_init_
    from racformer_tpu_torch.train.__main__ import build, to_device

    def variant(**fields):
        c = copy.deepcopy(cfg)
        c["model"].update(fields)
        return c

    def model_of(c):
        with torch.device(dev):
            m = RaCFormer(**config_kwargs(c))
        return random_init_(m, torch.Generator().manual_seed(SEED)).eval()

    total = np.zeros(4, dtype=np.int64)
    layers = int(cfg["decoder"]["num_layers"])
    m32 = model_of(cfg)
    m16 = model_of(variant(head_dtype="bfloat16"))
    frames = ring_frames(m32, HEAD_STEPS, 1536, SEED)
    # (a) the streaming eval step with each head, on phase 4's weights and
    # frames; the bf16 head's outputs against the f32 head's on one window
    ev32, l32 = head_steps(m32, frames, "[19] f32")
    ev16, l16 = head_steps(m16, frames, "[19] bf16")
    total += np.asarray(l32) + np.asarray(l16)
    check(tuple(l16) == (18 * HEAD_STEPS, 0, 0, 0),
          f"[19] bf16 head: launches {l16} in {HEAD_STEPS} steps, expected K1 "
          f"{18 * HEAD_STEPS} and no other")
    feat_cat, lss, radar, l2i, ts = ev32.cache
    args = (feat_cat, lss, radar, l2i, ts[:, :1] - ts)
    a, b = m32.decode_window(*args), m16.decode_window(*args)
    check(all(b[k].dtype == torch.float32 for k in ("all_cls_scores",
                                                    "all_bbox_preds")),
          "[19] the bf16 head's outputs are not float32")
    d_cls = (b["all_cls_scores"][-1] - a["all_cls_scores"][-1]).abs()
    d_box = (b["all_bbox_preds"][-1] - a["all_bbox_preds"][-1]).abs()
    print(f"[19] (a) streaming step, {HEAD_STEPS} steps each on phase 4's "
          f"weights and frames with the f32 and the bf16 head; K1 launches "
          f"per step {l16[0] // HEAD_STEPS}")
    print(f"[19] (a) bf16 head against the f32 head on one window (last "
          f"layer): class logits max |d| {d_cls.max().item():.4g}, median "
          f"{d_cls.median().item():.4g}; boxes max |d| {d_box.max().item():.4g}, "
          f"median {d_box.median().item():.4g} (bound: median |d box| < 0.5, "
          f"the JAX package's drift alarm); outputs float32, parameters "
          f"{sorted({str(p.dtype) for p in m16.parameters()})}")
    check(bool(torch.isfinite(d_cls).all() and torch.isfinite(d_box).all())
          and d_box.median().item() < 0.5,
          "[19] the bf16 head drifts from the f32 head")
    # (c) the unfolded samplers: K2's forward at every site, no K1, and no
    # decode captured as CUDA graphs (their K2 launches would go uncounted)
    mu = model_of(variant(fused_gather=False))
    evu, lu = head_steps(mu, frames, "[19] unfolded")
    total += np.asarray(lu)
    want = (0, SITES * layers * HEAD_STEPS, 0, 0)
    check(tuple(lu) == want, f"[19] fused_gather=False: launches {lu}, "
                             f"expected {want}")
    check(not evu.decoder_graphs.plans, "[19] fused_gather=False: a decode was "
                                "captured as CUDA graphs")
    reset_launch_counts()
    c = mu.decode_window(*args)
    total += np.asarray(launch_counts())
    tol_cls, tol_box = head_bound(a["all_cls_scores"][-1], a["all_bbox_preds"][-1])
    e_cls = (c["all_cls_scores"][-1] - a["all_cls_scores"][-1]).abs().max().item()
    e_box = (c["all_bbox_preds"][-1] - a["all_bbox_preds"][-1]).abs().max().item()
    print(f"[19] (c) fused_gather=False: decoded eagerly, launches per step K1 "
          f"{lu[0] // HEAD_STEPS}, K2 {lu[1] // HEAD_STEPS} (expected {SITES} "
          f"sites x {layers} iterations); against the folded step on one "
          f"window: class logits max |d| {e_cls:.4g} (bound {tol_cls:.4g}), "
          f"boxes max |d| {e_box:.4g} (bound {tol_box:.4g}, phase 5's)")
    check(e_cls <= tol_cls and e_box <= tol_box,
          "[19] the unfolded samplers disagree with the folded step")
    del ev32, ev16, evu, m32, m16, mu, a, b, c, args, feat_cat, lss, radar
    torch.cuda.empty_cache()

    # (b) train steps through the train driver's build: the f32 head's,
    # then the bf16 head's, each from the seeded weights on the same batches
    accum = int(cfg.get("accumulate_steps", 1))
    per = SITES * layers * accum
    want = (0, 2 * 2 * per, 2 * per, 2 * per)
    for name, tcfg in (("f32", cfg), ("bf16", variant(head_dtype="bfloat16"))):
        model, opt, train_step, dataset, batch = build(tcfg, dev, SEED, 1000)
        batches = [to_device(dataset.batch(list(range(i * batch,
                                                       (i + 1) * batch))), dev)
                   for i in range(3)]
        gen = torch.Generator().manual_seed(SEED + 1)
        reset_launch_counts()
        for i in range(2):
            metrics = train_step(batches[i], gen)
            losses = {k: float(v) for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in losses.values()),
                  f"[19] {name} head: non-finite losses or grad_norm {losses}")
            check(finite_grads(model), f"[19] {name} head: non-finite gradients")
        lt = launch_counts()
        total += np.asarray(lt)
        check(tuple(lt) == want, f"[19] {name}-head train launches {lt} in 2 "
                                 f"steps, expected {want}")
        dtypes = sorted({str(p.dtype) for p in model.parameters()})
        check(dtypes == ["torch.float32"], f"[19] parameters became {dtypes}")
        print(f"[19] (b) {name}-head train step (batch {batch}, {accum} "
              f"microbatches): launches per step K2 {lt[1] // 2}, K3 "
              f"{lt[2] // 2}, K4 {lt[3] // 2}; losses and grad_norm finite "
              f"(grad_norm {losses['grad_norm']:.5g}, loss_total "
              f"{losses['loss_total']:.5g}); parameters {dtypes}")
        if name == "bf16":
            step_own_inputs(train_step, batches[2], gen, timed=False,
                            tag="[19] (b)")
        del model, opt, train_step, dataset, batches
        torch.cuda.empty_cache()

    # (d) VoVNet V-99-eSE at the flagship's per-frame trunk input, and the
    # BEV nets on a 128^2 BEV of 256 channels
    from racformer_tpu_torch.nn.bev_nets import BEVResNet, FPNLSS
    from racformer_tpu_torch.nn.vovnet import VoVNet

    x = torch.randn(VOV_INPUT, generator=torch.Generator().manual_seed(SEED))
    x = x.to(dev)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        with torch.device(dev):
            net = VoVNet("V-99-eSE", dtype=dt)
        seeded_he_init_(net, torch.Generator().manual_seed(SEED)).eval()
        with torch.no_grad():
            outs[dt] = net(x)
        del net
    shapes = [tuple(o.shape) for o in outs[torch.float32]]
    H, W = VOV_INPUT[1:3]
    want = [(VOV_INPUT[0], H // s, W // s, c) for s, c in
            zip((4, 8, 16, 32), (256, 512, 768, 1024))]
    rel = [((o16.float() - o32).norm() / o32.norm()).item()
           for o16, o32 in zip(outs[torch.bfloat16], outs[torch.float32])]
    check(shapes == want and [tuple(o.shape) for o in outs[torch.bfloat16]]
          == want, f"[19] VoVNet shapes {shapes}, expected {want}")
    check(all(torch.isfinite(o).all() and o.abs().max() > 0
              for o in outs[torch.float32]) and max(rel) < 0.1,
          f"[19] VoVNet outputs degenerate or bf16 off f32 by {rel}")
    print(f"[19] (d) VoVNet V-99-eSE on {VOV_INPUT} (eval, frozen BN, He-normal "
          f"seeded weights): outputs {shapes}; bf16 against f32, relative "
          f"error (norm of the difference over the norm) per stage "
          f"{', '.join(f'{r:.4g}' for r in rel)}")
    del outs, x
    with torch.device(dev):
        bev_net, neck = BEVResNet(256), FPNLSS(512 + 2048, 256)
    g = torch.Generator().manual_seed(SEED)
    seeded_he_init_(bev_net, g).eval()
    seeded_he_init_(neck, g).eval()
    bev = torch.randn((1, 128, 128, 256), generator=g).to(dev)
    with torch.no_grad():
        feats = bev_net(bev)
        out = neck(feats)
    check([tuple(f.shape) for f in feats] == [(1, 64, 64, 512), (1, 32, 32, 1024),
                                               (1, 16, 16, 2048)]
          and tuple(out.shape) == (1, 128, 128, 256)
          and bool(torch.isfinite(out).all()), "[19] BEV nets: bad output")
    print(f"[19] (d) BEVResNet + FPNLSS on (1, 128, 128, 256) f32: stages "
          f"{[tuple(f.shape) for f in feats]}, out {tuple(out.shape)}")
    print(f"[19] launches of phase 19's runs: K1 {total[0]}, K2 {total[1]}, "
          f"K3 {total[2]}, K4 {total[3]}")
    return tuple(int(n) for n in total)


F16_STEPS = 5  # phase 20's streaming steps


def finite_outputs(out):
    """Whether a decoded window's last-layer logits and boxes are finite."""
    return bool(torch.isfinite(out["all_cls_scores"][-1]).all()
                and torch.isfinite(out["all_bbox_preds"][-1]).all())


def site_kernels(model, dev, dtype, tag, seed):
    """K1 at the three eval sites and K2-K4 at the three train sites of
    `model`'s shapes, `dtype` maps, each against its plain version (the
    wrapper under `force_reference()`) on the same inputs at phases 3's and
    7's tolerances (scaled to the dtype's epsilon), timed, with its bound
    and, for K2-K4, the library call. Returns {kernel: {err, ms, plain_ms,
    bound_ms, bound_by, library_ms}}, the times summed over the sites."""
    from racformer_tpu_torch.ops import gather_kernel as gk

    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     bound_by=set(), library_ms=0.0)
             for k in ("gather_fold", "patch_gather", "patch_scatter",
                       "patch_corner_grads")}

    def add(kname, err, t_k, t_p, t_b, by, t_l):
        st = stats[kname]
        st["err"] = max(st["err"], err)
        st["ms"] += t_k
        st["plain_ms"] += t_p
        st["bound_ms"] += t_b
        st["bound_by"].add(by)
        st["library_ms"] = (None if t_l is None or st["library_ms"] is None
                            else st["library_ms"] + t_l)

    for name, fmap, pts, fold, outside in site_cases(model, gen, dtype, dev):
        kern = functools.partial(gk.patch_sample_fold, fmap, *pts, fold)

        def plain():
            with gk.force_reference():
                return kern()

        ok, err, tol = fold_ok(kern(), plain())
        t_k = median_ms(kern)
        t_p = median_ms(plain, reps=5, warmup=1)
        t_b, by = bound_ms("gather_fold", fmap.shape, pts, fmap.element_size(),
                           fold)
        print(f"{tag} K1 {name:9s} {dtype} map {tuple(fmap.shape)} "
              f"K={pts[0].shape[1]} fold={fold} outside={outside:.3f}: "
              f"max_abs_err={err:.3g} ({tol}) {'ok' if ok else 'FAIL'}; "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {t_b:.4f} ms "
              f"({by}), share {t_b / t_k:.3f}; library: none")
        check(ok, f"{tag} K1 disagrees with its plain version at {name} {dtype}")
        add("gather_fold", err, t_k, t_p, t_b, by, None)
    for name, fmap, pts, g, outside in train_site_cases(model, gen, dtype, dev):
        shape = tuple(fmap.shape)
        lib = library_ms(fmap, pts, g)
        for kname, (kern, _) in patch_runs(fmap, pts, g).items():
            def plain(kern=kern):
                with gk.force_reference():
                    return kern()

            ok, err, detail, tol = compare(kname, kern(), plain(), dtype)
            t_k = median_ms(kern, reps=10, warmup=2)
            t_p = median_ms(plain, reps=3, warmup=1)
            t_b, by = bound_ms(kname, shape, pts, fmap.element_size())
            t_l = lib[kname]
            print(f"{tag} {kname:18s} {name:9s} {dtype} map {shape} "
                  f"K={pts[0].shape[1]} outside={outside:.3f}: max_abs_err "
                  f"{detail} ({tol}) {'ok' if ok else 'FAIL'}; kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {t_b:.4f} ms "
                  f"({by}), share {t_b / t_k:.3f}, library "
                  f"{'refused' if t_l is None else f'{t_l:.4f} ms'}")
            check(ok, f"{tag} {kname} disagrees with its plain version at "
                      f"{name} {dtype}")
            add(kname, err, t_k, t_p, t_b, by, t_l)
    for st in stats.values():
        st["bound_by"] = "/".join(sorted(st["bound_by"]))
    return stats


def stream_steps(model, frames, steps):
    """`steps` streaming steps of `model` on `frames`: (evaluator, outputs
    finite, launches)."""
    from racformer_tpu_torch.eval import StreamingEvaluator

    ev = StreamingEvaluator(model)
    reset_launch_counts()
    finite = True
    for f in frames[:steps]:
        out = ev.step(f, blocking=False)
        finite = finite and bool(torch.isfinite(out["scores"]).all()
                                 and torch.isfinite(out["bboxes"]).all())
    return ev, finite, launch_counts()


def window_pair(model, ev):
    """The evaluator's cached window decoded with K1 and with its plain
    version."""
    from racformer_tpu_torch.ops import gather_kernel as gk

    feat_cat, lss, radar, l2i, ts = ev.cache
    args = (feat_cat, lss, radar, l2i, ts[:, :1] - ts)
    a = model.decode_window(*args)
    with gk.force_reference():
        b = model.decode_window(*args)
    return a, b


def window_drift(tag, a, b):
    """Phase 5's check of a window decoded with K1 (a) against its plain
    version (b): the last layer's class logits and boxes."""
    tol_cls, tol_box = head_bound(b["all_cls_scores"][-1],
                                  b["all_bbox_preds"][-1])
    e_cls = (a["all_cls_scores"][-1] - b["all_cls_scores"][-1]).abs().max().item()
    e_box = (a["all_bbox_preds"][-1] - b["all_bbox_preds"][-1]).abs().max().item()
    print(f"{tag} last window, K1 against its plain version: class "
          f"logits max |d| {e_cls:.4g} (bound {tol_cls:.4g}), boxes max "
          f"|d| {e_box:.4g} (bound {tol_box:.4g}, phase 5's)")
    return e_cls <= tol_cls and e_box <= tol_box


def train_pair(cfg, dev):
    """One train step of `cfg`'s model (the train driver's `build`, batch of
    the config, lr 0) with the kernels and one with their plain versions
    from equal weights, batch and draws: (kernel metrics, plain metrics,
    their gradients, the kernel step's launches, batch, microbatches)."""
    from racformer_tpu_torch.ops import gather_kernel as gk
    from racformer_tpu_torch.train import (Optimizer, make_draws,
                                           make_train_step, split_microbatches)
    from racformer_tpu_torch.train.__main__ import build, to_device

    tmodel, _, _, dataset, batch = build(cfg, dev, SEED, 1000)
    accum = int(cfg.get("accumulate_steps", 1))
    tb = to_device(dataset.batch(list(range(batch))), dev)
    opt = Optimizer(tmodel.named_parameters(), base_lr=0.0)
    step = make_train_step(tmodel, opt, dict(cfg.get("depth", {})), accum)
    gen = torch.Generator().manual_seed(SEED + 2)
    draws = [make_draws(tmodel, m, gen) for m in split_microbatches(tb, accum)]
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    reset_launch_counts()
    ma = step(tb, draws=draws)
    launches = launch_counts()
    ga = grads_of(tmodel, ma)
    tmodel.load_state_dict(state)
    before = launch_counts()
    with gk.force_reference():
        mb = step(tb, draws=draws)
    check(launch_counts() == before, "force_reference() launched a kernel")
    gb = grads_of(tmodel, mb)
    return ma, mb, ga, gb, launches, batch, accum


def finite_step(metrics, grads):
    """Whether a train step's losses and gradients are all finite."""
    return all(np.isfinite(float(v)) for v in metrics.values()) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())


def phase_float16(cfg, dev):
    """Phase 20: float16 maps (`model.trunk_dtype` and `decoder.gather_dtype`
    float16, read through `config_kwargs`) at the flagship config's full
    width, seeded random weights: (a) K1-K4 against their plain versions at
    the flagship sites (`site_kernels`); (b) F16_STEPS streaming steps (K1
    18 a step) and the last window
    decoded with the kernels and with their plain versions (phase 5's
    bound); (c) one train step with the kernels (K2 72, K3 and K4 36) and
    one with their plain versions from equal weights, batch and draws
    (phase 9's bound). Where the seeded weights overflow float16 on the
    kernel path and the plain path alike, that is the configuration's
    property: the run prints it and the kernels stay held at the op level
    by (a); an overflow on one path only fails. Returns ((a)'s stats, the
    (K1, K2, K3, K4) launches of (b)'s steps and (c)'s kernel step)."""
    import copy

    from racformer_tpu_torch.model import RaCFormer, config_kwargs, random_init_

    f16 = torch.float16
    c16 = copy.deepcopy(cfg)
    c16["model"]["trunk_dtype"] = "float16"
    c16["decoder"]["gather_dtype"] = "float16"
    kwargs = config_kwargs(c16)
    check(kwargs["trunk_dtype"] == f16
          and kwargs["decoder"]["gather_dtype"] == f16,
          "[20] config_kwargs did not take the float16 overrides")
    with torch.device(dev):
        model = RaCFormer(**kwargs)
    random_init_(model, torch.Generator().manual_seed(SEED)).eval()
    stats = site_kernels(model, dev, f16, "[20]", SEED + 20)
    layers = int(cfg["decoder"]["num_layers"])

    # (b) the streaming step
    frames = ring_frames(model, F16_STEPS, 1536, SEED)
    ev, finite, l_eval = stream_steps(model, frames, F16_STEPS)
    check(tuple(l_eval) == (18 * F16_STEPS, 0, 0, 0),
          f"[20] float16 streaming launches {l_eval} in {F16_STEPS} steps, "
          f"expected K1 {18 * F16_STEPS} and no other")
    feat_cat, lss, radar = ev.cache[:3]
    check(feat_cat.dtype == f16,
          f"[20] the cached image pyramid is {feat_cat.dtype}, expected float16")
    tops = [t.float().abs().max().item() for t in (feat_cat, lss, radar)]
    a, b = window_pair(model, ev)
    fin_a, fin_b = finite_outputs(a), finite_outputs(b)
    print(f"[20] (b) float16 streaming step: {F16_STEPS} steps, K1 launches "
          f"per step {l_eval[0] // F16_STEPS}; outputs finite {finite}; "
          f"largest |value| "
          f"of the float16 image pyramid {tops[0]:.4g}, of the cached float32 "
          f"LSS BEV {tops[1]:.4g} and radar BEV {tops[2]:.4g}, which the "
          f"decoder projects into its float16 value maps (float16 max "
          f"{torch.finfo(f16).max:g})")
    overflow = []
    if fin_a and fin_b:
        check(window_drift("[20] (b)", a, b) and finite,
              "[20] the float16 streaming step with K1 drifts from the plain "
              "version, or its steps were not finite")
    else:
        check(not fin_a and not fin_b and not finite,
              f"[20] float16 window finite with the kernels {fin_a}, with the "
              f"plain versions {fin_b}, steps finite {finite}: one path only "
              f"overflowed")
        overflow.append("eval")
        print(f"[20] (b) OVERFLOW: the seeded weights overflow float16 in the "
              f"eval step with the kernels and with their plain versions alike "
              f"(a property of the configuration, not of K1; K1 held at the op "
              f"level in (a))")
    del ev, a, b, feat_cat, lss, radar, model
    torch.cuda.empty_cache()

    # (c) one train step with the kernels, one with their plain versions
    ma, mb, ga, gb, l_train, batch, accum = train_pair(c16, dev)
    per = SITES * layers * accum
    check(tuple(l_train) == (0, 2 * per, per, per),
          f"[20] float16 train step launches {l_train}, expected "
          f"{(0, 2 * per, per, per)}")
    fin_a, fin_b = finite_step(ma, ga), finite_step(mb, gb)
    print(f"[20] (c) float16 train step (batch {batch}, {accum} microbatches): "
          f"launches K2 {l_train[1]}, K3 "
          f"{l_train[2]}, K4 {l_train[3]}; loss_total {float(ma['loss_total']):.6g}"
          f" / {float(mb['loss_total']):.6g}, grad_norm "
          f"{float(ma['grad_norm']):.6g} / {float(mb['grad_norm']):.6g} "
          f"(kernels / plain versions)")
    if fin_a and fin_b:
        loss_rel, cos, rel = compare_steps(
            "[20] (c) float16 train step, kernels vs plain versions:", ma, mb,
            ga, gb)
        check(loss_rel <= 1e-3 and cos >= 0.99 and rel <= 0.05,
              "[20] the float16 train step with the kernels drifts from the "
              "plain versions (phase 9's bound: losses 1e-3 relative, every "
              "gradient's cosine >= 0.99, global relative gradient difference "
              "<= 0.05)")
    else:
        check(not fin_a and not fin_b,
              f"[20] float16 train step finite with the kernels {fin_a}, with "
              f"the plain versions {fin_b}: one path only overflowed")
        overflow.append("train")
        print(f"[20] (c) OVERFLOW: the seeded weights overflow float16 in the "
              f"train step with the kernels and with their plain versions "
              f"alike (a property of the configuration, not of K2-K4; they "
              f"are held at the op level in (a))")
    del ma, mb, ga, gb
    torch.cuda.empty_cache()
    launches = tuple(int(x) + int(y) for x, y in zip(l_eval, l_train))
    print(f"[20] float16 launches on the main path: K1 {launches[0]}, K2 "
          f"{launches[1]}, K3 {launches[2]}, K4 {launches[3]}; overflow: "
          f"{', '.join(overflow) or 'none'}")
    return stats, launches


FRONT_CONFIG = (REPO / "racformer_tpu_torch" / "configs"
                / "racformer_r50_nuimg_704x256_f8_3cam_3rad.py")
FRONT_MINI_CONFIG = FRONT_CONFIG.with_name(
    "racformer_r50_nuimg_704x256_f8_3cam_3rad_mini.py")
FRONT_STEPS = 5  # phase 21's streaming steps
FRONT_TRAIN_SAMPLES = 4  # one epoch of 2 train-driver steps at batch 2


@contextlib.contextmanager
def metrics_calls():
    """Records every `detection_metrics` call the drivers make (both import
    it from `eval.offline` when they evaluate): its gts and keywords."""
    from racformer_tpu_torch.eval import offline

    calls, real = [], offline.detection_metrics

    def spy(preds, gts, **kw):
        calls.append(dict(preds=preds, gts=gts, **kw))
        return real(preds, gts, **kw)

    offline.detection_metrics = spy
    try:
        yield calls
    finally:
        offline.detection_metrics = real


def gt_counted(call, front_only):
    """The GT boxes a recorded metrics call counts, with or without the
    front-only filter (through `gt_filter`, which sees the boxes that pass
    every protocol filter)."""
    from racformer_tpu_torch.eval.metrics import nuscenes_metrics

    seen = []

    def count(i, boxes, labels, g):
        seen.append(len(boxes))
        return np.ones(len(boxes), bool)

    nuscenes_metrics(call["preds"], call["gts"], front_only=front_only,
                     gt_filter=count)
    return sum(seen)


def front_only_acts(tag, call):
    """The call took the front-only flag, and the filter keeps some GT boxes
    but not all."""
    every, front = gt_counted(call, False), gt_counted(call, True)
    print(f"{tag} metrics front_only={call['front_only']}: GT boxes counted "
          f"{front} with the filter, {every} without")
    check(call["front_only"] is True and 0 < front < every,
          f"{tag} the front-only filter did not act")


def phase_front(dev):
    """Phase 21: the fork's front-only configuration (the port's copy of
    racformer_r50_nuimg_704x256_f8_3cam_3rad.py: 3 cameras, 3 radars,
    `eval_front_only`) unreduced, seeded random weights: (a) K1-K4 at its
    sites in bf16 against their plain versions (`site_kernels`); (b)
    FRONT_STEPS streaming steps (K1 18 a step) and the last window against
    K1's plain version (phase 5's bound); (c) one train step with K2-K4
    (72 / 36 / 36) against their plain versions (phase 9's bound); (d) the
    eval driver with the _mini config on phase 13's nuScenes-layout split,
    --streaming and offline, its front-only filter acting on the GT; (e)
    the train driver 2 steps on that split with an in-training eval and a
    verified checkpoint. Returns ((a)'s stats, the (K1, K2, K3, K4)
    launches of (b), (c)'s kernel step, (d) and (e))."""
    import pickle
    import tempfile

    from racformer_tpu_torch.config import Config
    from racformer_tpu_torch.eval.__main__ import camera_types
    from racformer_tpu_torch.eval.__main__ import main as eval_main
    from racformer_tpu_torch.model import RaCFormer, config_kwargs, random_init_
    from racformer_tpu_torch.train.__main__ import main as train_main

    cfg = Config.fromfile(str(FRONT_CONFIG))
    kwargs = config_kwargs(cfg)
    layers = int(cfg["decoder"]["num_layers"])
    with torch.device(dev):
        model = RaCFormer(**kwargs)
    random_init_(model, torch.Generator().manual_seed(SEED)).eval()
    cams = camera_types(cfg, model)
    print(f"[21] {FRONT_CONFIG.relative_to(REPO)}: cameras {list(cams)}, "
          f"radars {cfg['radar_types']}, {kwargs['num_frames']} frames, "
          f"{kwargs['image_hw']}, Q={kwargs['num_query']}, "
          f"C={kwargs['embed_dims']}, {layers} layers, "
          f"D={kwargs['depth_bins']}, BEV {kwargs['bev_size']}, "
          f"eval_front_only={cfg['eval_front_only']}; "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    check(model.num_cams == 3 and len(cams) == 3 and cfg["eval_front_only"],
          "[21] the front-only config does not name 3 cameras and front-only "
          "evaluation")
    launches = np.zeros(4, np.int64)

    # (a) K1-K4 at the N = 3 sites
    stats = site_kernels(model, dev, torch.bfloat16, "[21] (a)", SEED + 21)

    # (b) the streaming step
    frames = ring_frames(model, FRONT_STEPS, int(cfg["radar"]["max_points"]),
                         SEED)
    ev, finite, l_eval = stream_steps(model, frames, FRONT_STEPS)
    launches += l_eval
    print(f"[21] (b) streaming step, 3 cameras: {FRONT_STEPS} steps, K1 "
          f"launches per step {l_eval[0] / FRONT_STEPS:g}; outputs finite "
          f"{finite}")
    check(tuple(l_eval) == (18 * FRONT_STEPS, 0, 0, 0),
          f"[21] streaming launches {l_eval} in {FRONT_STEPS} steps, expected "
          f"K1 {18 * FRONT_STEPS} and no other")
    a, b = window_pair(model, ev)
    check(finite and finite_outputs(a) and window_drift("[21] (b)", a, b),
          "[21] the streaming step with K1 drifts from the plain version, or "
          "its outputs were not finite")
    del ev, a, b, model
    torch.cuda.empty_cache()

    # (c) one train step with the kernels, one with their plain versions
    ma, mb, ga, gb, l_train, batch, accum = train_pair(cfg, dev)
    launches += l_train
    per = SITES * layers * accum
    print(f"[21] (c) train step, 3 cameras (batch {batch}, {accum} "
          f"microbatches): launches K2 {l_train[1]}, K3 "
          f"{l_train[2]}, K4 {l_train[3]}; loss_total "
          f"{float(ma['loss_total']):.6g} / {float(mb['loss_total']):.6g}, "
          f"grad_norm {float(ma['grad_norm']):.6g} / "
          f"{float(mb['grad_norm']):.6g} (kernels / plain versions)")
    check(tuple(l_train) == (0, 2 * per, per, per),
          f"[21] train step launches {l_train}, expected {(0, 2 * per, per, per)}")
    check(finite_step(ma, ga) and finite_step(mb, gb),
          "[21] the train step's losses or gradients are not finite")
    loss_rel, cos, rel = compare_steps(
        "[21] (c) train step, kernels vs plain versions:", ma, mb, ga, gb)
    check(loss_rel <= 1e-3 and cos >= 0.99 and rel <= 0.05,
          "[21] the train step with the kernels drifts from the plain versions "
          "(phase 9's bound: losses 1e-3 relative, every gradient's cosine "
          ">= 0.99, global relative gradient difference <= 0.05)")
    del ma, mb, ga, gb
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # (d) the eval driver, front-only, on a nuScenes-layout split
        n = NUSC_SCENES * NUSC_SAMPLES
        ann = write_nuscenes_split(Path(tmp))
        print(f"[21] (d) the eval driver on {FRONT_MINI_CONFIG.name}: {n} "
              f"keyframes of phase 13's split ({len(NUSC_CAMS)} cameras), "
              f"read through cameras {list(cams)}")
        for name, extra in (("--streaming", ["--streaming"]), ("offline", [])):
            reset_launch_counts()
            with metrics_calls() as calls:
                (preds, metrics), text = run_driver(eval_main, [
                    "--config", str(FRONT_MINI_CONFIG), "--override",
                    f"data.val.ann_file={ann}", *extra])
            l_drv = launch_counts()
            launches += l_drv
            line = [l for l in text.splitlines() if l.startswith("eval:")]
            print(f"[21] (d) eval driver {name}: "
                  f"{line[0] if line else 'no eval line'}; K1 launches "
                  f"{l_drv[0]}; metrics "
                  f"{json.dumps({k: round(float(v), 4) for k, v in (metrics or {}).items() if isinstance(v, (int, float))})}")
            check(f"eval: {n} samples" in text and '"NDS"' in text,
                  f"[21] eval driver {name}: no eval line or metrics")
            check(metrics is not None and all(
                np.isfinite(float(v)) for v in metrics.values()
                if isinstance(v, (int, float))),
                f"[21] eval driver {name}: metrics")
            check(len(preds) == n and all(
                np.isfinite(p["scores"]).all() and np.isfinite(p["bboxes"]).all()
                for p in preds), f"[21] eval driver {name}: predictions")
            check(tuple(l_drv) == (18 * n, 0, 0, 0),
                  f"[21] eval driver {name}: launches {l_drv}, expected K1 "
                  f"{18 * n}")
            check(len(calls) == 1, f"[21] eval driver {name}: metrics calls "
                                   f"{len(calls)}")
            front_only_acts(f"[21] (d) eval driver {name}:", calls[0])

        # (e) the train driver: 2 steps (one epoch) and an in-training eval
        with open(ann, "rb") as f:
            infos = pickle.load(f)["infos"][:FRONT_TRAIN_SAMPLES]
        train_ann = Path(tmp) / "nuscenes_infos_train_sweep.pkl"
        with open(train_ann, "wb") as f:
            pickle.dump({"infos": infos}, f)
        want = (0, 2 * per, per, per)
        reset_launch_counts()
        with metrics_calls() as calls:
            res, out = run_driver(train_main, [
                "--config", str(FRONT_CONFIG), "--work-dir",
                str(Path(tmp) / "wd"), "--max-steps", "2", "--override",
                f"data.train.ann_file={train_ann}", f"data.val.ann_file={ann}",
                "evaluation.interval=1", "evaluation.max_samples=2",
                "log_interval=1"])
        launches += launch_counts()
        for sv in res["saves"]:
            print(f"[21] (e) checkpoint step {sv['step']}: {sv['bytes']} B, "
                  f"verified {sv['verified']}")
        for e in res["evals"]:
            print(f"[21] (e) in-training eval @ {e['step']}: {e['samples']} "
                  f"samples, K1 launches {e['k1_launches']}, NDS "
                  f"{e.get('metrics', {}).get('NDS')}")
        check(res["last_step"] == 2 and "training done" in out,
              "[21] train driver: not 2 steps")
        check_driver_steps("[21] (e) train driver", res, want)
        rec = [json.loads(line) for line in
               (Path(tmp) / "wd" / "metrics.jsonl").read_text().splitlines()]
        check(rec and all(np.isfinite(r["loss_total"]) for r in rec
                          if "loss_total" in r),
              "[21] train driver: a loss is not finite")
        check(res["saves"] and all(sv["verified"] for sv in res["saves"]),
              "[21] train driver: a checkpoint failed verification")
        check(len(res["evals"]) == 1 and res["evals"][0]["k1_launches"] == 36,
              f"[21] train driver: in-training evals {res['evals']}")
        check(len(calls) == 1, f"[21] train driver: metrics calls {len(calls)}")
        front_only_acts("[21] (e) in-training eval:", calls[0])
        del res
    torch.cuda.empty_cache()
    launches = tuple(int(x) for x in launches)
    print(f"[21] front-only launches on the main path: K1 {launches[0]}, K2 "
          f"{launches[1]}, K3 {launches[2]}, K4 {launches[3]}")
    return stats, launches


def lap_steps(cost_gq):
    """The Dijkstra steps `train.matching.lap_single` takes on one [G, Q]
    cost: a copy of its loop that counts them."""
    inf = np.float32(1.0e18)
    G, Q = cost_gq.shape
    cost = np.zeros((G + 1, Q + 1), np.float32)
    cost[1:, 1:] = cost_gq
    u = np.zeros(G + 1, np.float32)
    v = np.zeros(Q + 1, np.float32)
    p = np.zeros(Q + 1, np.int64)
    steps = 0
    for i in range(1, G + 1):
        p[0] = i
        minv = np.full(Q + 1, inf, np.float32)
        way = np.zeros(Q + 1, np.int64)
        used = np.zeros(Q + 1, bool)
        j0 = 0
        while p[j0] != 0:
            steps += 1
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0] - u[i0] - v
            better = ~used & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            masked = np.where(used, inf, minv)
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            u[p[used]] += delta
            v = v - np.where(used, delta, np.float32(0.0))
            minv = np.where(used, minv, minv - delta)
            j0 = j1
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    return steps


def lap_case(tag, cost):
    """The matching kernel on `cost` [..., Q, G] against `assign_host`:
    printed, checked equal; returns the kernel's ms a call."""
    from racformer_tpu_torch.train import matching

    host_cost = cost.cpu().numpy()
    got = matching.hungarian_assign(cost).cpu().numpy()
    t0 = time.perf_counter()
    want = matching.assign_host(host_cost)
    host = (time.perf_counter() - t0) * 1e3
    ms = median_ms(lambda: matching.hungarian_assign(cost), reps=10, warmup=2)
    Q, G = cost.shape[-2:]
    steps = [lap_steps(c.T) for c in host_cost.reshape(-1, Q, G)]
    equal = np.array_equal(got, want)
    print(f"[22] {tag} cost {tuple(cost.shape)}: kernel {ms:.3f} ms a call, "
          f"assign_host {host:.1f} ms; Dijkstra steps {sum(steps)} "
          f"(longest problem {max(steps)}): {ms * 1e3 / max(steps):.3f} us a "
          f"step of the longest; equal to assign_host: {equal}")
    check(equal, f"the matching kernel differs from assign_host on {tag}")
    return ms


def loss_cost(valid, dev, seed, layers=6, queries=900, rows=64):
    """The loss's matching cost [layers, 1, queries, rows] on `dev` from
    random head outputs and GT boxes, the first `valid` GT rows valid (the
    others cost BIG)."""
    from racformer_tpu_torch.train import losses, matching

    rng = np.random.default_rng(seed)
    boxes = np.zeros((1, rows, 9), np.float32)
    boxes[..., :3] = rng.uniform(-50, 50, (1, rows, 3))
    boxes[..., 3:6] = rng.uniform(0.5, 5.0, (1, rows, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (1, rows))
    labels = rng.integers(0, 10, (1, rows))
    mask = np.arange(rows)[None] < valid
    cls = rng.normal(size=(layers, 1, queries, 10)).astype(np.float32)
    box = rng.normal(size=(layers, 1, queries, 10)).astype(np.float32) * 2
    t = lambda a: torch.as_tensor(a, device=dev)
    return matching.match_cost(t(cls), t(box), t(boxes)[None], t(labels)[None],
                               t(mask)[None], losses.CODE_WEIGHTS)


def phase_lap(cfg, dev, card):
    """[22] The matching kernel against the host solver."""
    from racformer_tpu_torch.train import losses, matching
    from racformer_tpu_torch.train.__main__ import build, to_device

    launches = matching.LAP_LAUNCHES
    for valid in (5, 32, 64):
        lap_case(f"{valid} valid rows of 64,", loss_cost(valid, dev, valid))
    model, _, train_step, dataset, batch = build(cfg, dev, SEED, 1000)
    costs = []
    orig = losses.hungarian_assign

    def spy(cost):
        costs.append(cost.clone())
        return orig(cost)

    losses.hungarian_assign = spy
    try:
        train_step(to_device(dataset.batch(list(range(batch))), dev),
                   torch.Generator().manual_seed(SEED))
    finally:
        losses.hungarian_assign = orig
    for i, cost in enumerate(costs):
        valid = (cost[0, :, 0, :] < matching.BIG).sum(-1).tolist()
        lap_case(f"train step microbatch {i + 1} ({valid} valid rows),", cost)
    n = matching.LAP_LAUNCHES - launches
    print(f"[22] {card}: matching kernel launches {n} (the train step's "
          f"{len(costs)} included)")
    check(len(costs) == int(cfg.get("accumulate_steps", 1)),
          f"{len(costs)} matchings in a train step")
    del model
    torch.cuda.empty_cache()


def flagship_model(dev):
    """The flagship config (read with runpy), the model's arguments and the
    model on `dev` with seeded random weights, in eval mode."""
    from racformer_tpu_torch.model import RaCFormer, config_kwargs, random_init_

    cfg = runpy.run_path(str(CONFIG))
    kwargs = config_kwargs(cfg)
    with torch.device(dev):
        model = RaCFormer(**kwargs)
    random_init_(model, torch.Generator().manual_seed(SEED)).eval()
    return cfg, kwargs, model


def main(argv):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    card = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    cfg, kwargs, model = flagship_model(dev)
    print(f"[model] {CONFIG.relative_to(REPO)}: {kwargs['num_cams']} cams, "
          f"{kwargs['num_frames']} frames, {kwargs['image_hw']}, "
          f"Q={kwargs['num_query']}, C={kwargs['embed_dims']}, "
          f"{cfg['decoder']['num_layers']} layers, D={kwargs['depth_bins']}, "
          f"BEV {kwargs['bev_size']}; "
          f"{sum(p.numel() for p in model.parameters())} parameters")

    max_err, k_ms, p_ms, b_ms, b_by = phase_kernel(model, dev)
    ev, launches = phase_main(model)
    phase_reference(model, ev)
    del ev
    torch.cuda.empty_cache()
    phase_small(dev)
    ms_launches = phase_multistream(model)
    off_launches = phase_offline(model)
    patch = phase_patch_kernels(model, dev)
    del model
    torch.cuda.empty_cache()
    tmodel, tbatch, tlaunches = phase_train(cfg, dev)
    phase_train_reference(tmodel, tbatch, cfg, dev)
    del tmodel, tbatch
    torch.cuda.empty_cache()
    phase_lap(cfg, dev, card)
    phase_train_small(dev)
    drv_launches = phase_driver()
    train_drv = phase_train_driver(cfg)
    cards = torch.cuda.device_count()
    ddp_launches = phase_ddp_train(cfg, cards)
    ddp_k1 = phase_ddp_eval(cards)
    remat_launches = phase_remat(cfg, dev)
    vod_launches = phase_vod(dev)
    head_launches = phase_head_dtype(cfg, dev)
    f16_stats, f16_launches = phase_float16(cfg, dev)
    front_stats, front_launches = phase_front(dev)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "racformer_tpu"))
    check(not foreign, f"the port imported JAX or the JAX package: {foreign}")
    k1_launches = launches + ms_launches + off_launches + drv_launches + \
        train_drv[0] + ddp_k1 + vod_launches[0] + head_launches[0] + \
        front_launches[0]
    print(f"[-] K1 launches on the eval paths: {k1_launches} = streaming "
          f"{launches} + {MS_STREAMS} streams {ms_launches} + offline "
          f"{off_launches} + eval driver {drv_launches} + train driver's evals "
          f"and the eval driver on its work dir {train_drv[0]} + the eval "
          f"driver under torchrun (phase 16, every rank) {ddp_k1} + VoD "
          f"(phase 18) {vod_launches[0]} + head dtypes (phase 19) "
          f"{head_launches[0]} + front-only config (phase 21) "
          f"{front_launches[0]}")
    print(f"[-] K2, K3, K4 launches: train steps (phase 8) {tlaunches[1:]} + "
          f"train driver (phase 14) {train_drv[1:]} + train driver under "
          f"torchrun (phase 15, every rank) {ddp_launches[1:]} + remat "
          f"policies (phase 17) {remat_launches[1:]} + VoD (phase 18) "
          f"{vod_launches[1:]} + bf16 head and unfolded samplers (phase 19) "
          f"{head_launches[1:]} + front-only config (phase 21) "
          f"{front_launches[1:]}")
    kernels = [{
        "name": "gather_fold", "route": "cuda",
        "source": "racformer_tpu_torch/csrc/gather_fold.cu",
        "replaces": "racformer_tpu/ops/gather_kernel.py:187",
        "launches": k1_launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]
    for (name, replaces), n, m in zip((
            ("patch_gather", "racformer_tpu/ops/gather_kernel.py:53"),
            ("patch_scatter", "racformer_tpu/ops/scatter_kernel.py:47"),
            ("patch_corner_grads", "racformer_tpu/ops/gather_kernel.py:80")),
            tlaunches[1:], [sum(x) for x in zip(
                train_drv[1:], ddp_launches[1:], remat_launches[1:],
                vod_launches[1:], head_launches[1:], front_launches[1:])]):
        st = patch[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"racformer_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces, "launches": n + m,
                        "max_abs_err": st["err"], "ms": st["ms"],
                        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"],
                        "library_ms": st["library_ms"]})
    for (name, replaces), n in zip((
            ("gather_fold", "racformer_tpu/ops/gather_kernel.py:187"),
            ("patch_gather", "racformer_tpu/ops/gather_kernel.py:53"),
            ("patch_scatter", "racformer_tpu/ops/scatter_kernel.py:47"),
            ("patch_corner_grads", "racformer_tpu/ops/gather_kernel.py:80")),
            f16_launches):
        st = f16_stats[name]
        kernels.append({"name": f"{name}_float16", "route": "cuda",
                        "source": f"racformer_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces, "launches": n,
                        "max_abs_err": st["err"], "ms": st["ms"],
                        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"],
                        "library_ms": st["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2:])
        sys.exit(0)
    try:
        main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
