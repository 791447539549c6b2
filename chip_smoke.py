#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`racformer_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                   # needs one CUDA card
    python3 chip_smoke.py --profile FILE    # also profiles three steady
                                            # streaming steps and writes the
                                            # torch.profiler table to FILE

Phases, each printed as it runs; any failure exits non-zero:
  1. card and settings: the card's name and power limit, both TF32 flags
     (set off: the f32 head runs in full f32);
  2. building the CUDA kernel K1 (csrc/gather_fold.cu) from this checkout;
  3. K1 against its plain PyTorch version at the three decoder sites' flagship
     shapes, f32 and bf16 maps, ~20% of the points outside the map;
  4. the main path: the flagship model of
     racformer_tpu/configs/racformer_r50_nuimg_704x256_f8.py with seeded
     random weights, fed seeded synthetic ring-camera frames through
     `StreamingEvaluator.step`; K1 must launch 18 times per step (3 sites x 6
     decoder iterations);
  5. the last window decoded again with K1 routed to the plain version;
  6. a small config run on the card (kernel) and on the CPU (plain version).
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import runpy
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "racformer_tpu" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] tf32: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from racformer_tpu_torch.ops import cuda_lib, gather_kernel

    t0 = time.perf_counter()
    gather_kernel.build()
    secs = time.perf_counter() - t0
    print(f"[2] built K1 (csrc/gather_fold.cu, sm_90a) in {secs:.2f} s")
    for line in cuda_lib.build_logs.get("gather_fold", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2] ptxas: {line.strip()}")


def phase_kernel(model, dev):
    from racformer_tpu_torch.ops import gather_kernel as gk

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, ms, plain_ms = [], 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, fmap, pts, fold, outside in site_cases(model, gen, dtype, dev):
            got = gk.patch_sample_fold(fmap, *pts, fold)
            want = gk.patch_sample_fold_reference(fmap, *pts, fold)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref_max = want.float().abs().max().item()
            if dtype == torch.float32:
                ok = err <= 1e-5
                tol = "atol 1e-5"
            else:
                bound = 1e-2 * ref_max
                ok = bool(((got.float() - want.float()).abs()
                           <= bound + 1e-2 * want.float().abs()).all())
                tol = f"rtol 1e-2 + atol {bound:.3g} (1e-2 max|ref|)"
            t_k = median_ms(lambda: gk.patch_sample_fold(fmap, *pts, fold))
            t_p = median_ms(lambda: gk.patch_sample_fold_reference(
                fmap, *pts, fold), reps=5, warmup=1)
            print(f"[3] K1 {name:9s} {str(dtype):14s} map {tuple(fmap.shape)} "
                  f"K={pts[0].shape[1]} fold={fold} outside={outside:.3f}: "
                  f"max_abs_err={err:.3g} ({tol}) {'ok' if ok else 'FAIL'}; "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            check(ok, f"K1 disagrees with its plain version at {name} {dtype}")
            errs.append(err)
            if dtype == torch.bfloat16:  # the main path's map dtype
                ms += t_k
                plain_ms += t_p
    return max(errs), ms, plain_ms


def phase_main(model, dev, profile_path):
    from racformer_tpu_torch.eval import StreamingEvaluator
    from racformer_tpu_torch.ops import gather_kernel as gk
    from racformer_tpu_torch.ops import sampling

    frames = ring_frames(model, STEPS + 4, 1536, SEED)
    ev = StreamingEvaluator(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, outs = [], []
    gk.LAUNCHES = 0
    for frame in frames[:STEPS]:
        t0 = time.perf_counter()
        out = ev.step(frame, blocking=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = gk.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    check(launches == 18 * STEPS,
          f"K1 launched {launches} times in {STEPS} steps, expected {18 * STEPS}")
    head = model.pts_bbox_head
    n_boxes = min(300, head.num_query * head.num_classes)
    for out in outs:
        check(tuple(out["bboxes"].shape) == (1, n_boxes, 9), "bad box shape")
        check(bool(torch.isfinite(out["scores"]).all())
              and bool(torch.isfinite(out["bboxes"]).all()),
              "non-finite scores or boxes")
    steady = statistics.median(step_ms[2:])
    print(f"[4] {STEPS} streaming steps: K1 launches {launches} "
          f"({launches // STEPS} per step); outputs finite, boxes "
          f"{tuple(outs[-1]['bboxes'].shape)}, valid boxes in last step "
          f"{int(outs[-1]['valid'].sum())}")
    print(f"[4] step ms: first {step_ms[0]:.2f}, second {step_ms[1]:.2f}, "
          f"steady median {steady:.2f} (min {min(step_ms[2:]):.2f}, "
          f"max {max(step_ms[2:]):.2f}) over steps 3..{STEPS}")
    print(f"[4] peak device memory (max_memory_allocated): {peak} B "
          f"({peak / 2**30:.2f} GiB)")

    # share of image sample points that some camera sees, on one more step
    seen = []
    orig = sampling.project_points_to_views

    def recording(points, lidar2img, h, w, eps=1e-5):
        x, y, view = orig(points, lidar2img, h, w, eps)
        seen.append(((x > 0) & (x < 1) & (y > 0) & (y < 1)).float().mean().item())
        return x, y, view

    sampling.project_points_to_views = recording
    try:
        ev.step(frames[STEPS], blocking=False)
    finally:
        sampling.project_points_to_views = orig
    print(f"[4] in-view share of image sample points per decoder iteration: "
          f"{', '.join(f'{s:.3f}' for s in seen)}")
    check(min(seen) > 0.05, "image sample points are (almost) never in view")

    if profile_path:
        profile_steps(ev, frames[STEPS + 1:STEPS + 4], steady, profile_path)
    return ev, steady, peak, launches


def profiled(fn, runs):
    """Run fn() `runs` times under torch.profiler. Returns (key_averages,
    device ms per run: kernels and copies, the table's 'Self CUDA' total)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return events, busy / 1e3 / runs


def host_ms(fn, runs=5):
    """Median host-clock ms of fn() bracketed by synchronizes."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_steps(ev, frames, steady_ms, path):
    """Device time of whole steps and of the two stages, against host time;
    the op table goes to `path`."""
    from racformer_tpu_torch.model import preprocess_images

    it = iter(frames)
    events, busy = profiled(lambda: ev.step(next(it), blocking=False), 3)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=80))
    print(f"[4] profile of 3 steps: device busy {busy:.2f} ms/step against the "
          f"unprofiled steady step {steady_ms:.2f} ms: idle share "
          f"{max(0.0, 1 - busy / steady_ms):.3f} "
          f"(table: {path})")
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:10]
    for e in ops:
        print(f"[4]   {e.self_device_time_total / 3e3:8.3f} ms/step device  "
              f"{e.count // 3:5d} calls/step  {e.key}")
    print(f"[4]   aten ops launched per step: "
          f"{sum(e.count for e in events if e.key.startswith('aten::')) // 3}")

    # the two stages on the cached window: encode_frame, decode_window
    model, dev = ev.model, ev.device
    f = frames[0]
    t = {k: torch.as_tensor(np.asarray(f[k])).to(dev)[None] for k in (
        "imgs", "radar_points", "radar_mask", "radar_depth", "radar_rcs",
        "img2lidar")}
    enc_args = (preprocess_images(t["imgs"]), t["radar_points"],
                t["radar_mask"], t["radar_depth"], t["radar_rcs"], t["img2lidar"])
    feat_cat, lss, radar, l2i, ts = ev.cache
    dec_args = (feat_cat, lss, radar, l2i, ts[:, :1] - ts)
    for name, fn in (("encode_frame", lambda: model.encode_frame(*enc_args)),
                     ("decode_window", lambda: model.decode_window(*dec_args))):
        wall = host_ms(fn)
        _, dev_ms = profiled(fn, 3)
        print(f"[4] stage {name}: host {wall:.2f} ms, device busy {dev_ms:.2f} "
              f"ms, idle share {max(0.0, 1 - dev_ms / wall):.3f}")


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


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="FILE",
                        help="profile three steady streaming steps and write "
                             "the torch.profiler table to FILE")
    args = parser.parse_args(argv)
    card = phase_card()
    dev = torch.device("cuda", 0)
    from racformer_tpu_torch.model import RaCFormer, random_init_
    from racformer_tpu_torch.ops import gather_kernel as gk

    phase_build()
    cfg = runpy.run_path(str(CONFIG))
    mcfg = cfg["model"]
    kwargs = {k: mcfg[k] for k in (
        "num_cams", "num_frames", "embed_dims", "num_query", "num_clusters",
        "num_levels", "num_groups", "image_hw", "pc_range", "depth_bins",
        "bev_size")}
    kwargs["num_classes"] = len(cfg["class_names"])
    with torch.device(dev):
        model = RaCFormer(**kwargs, decoder=dict(cfg["decoder"]))
    random_init_(model, torch.Generator().manual_seed(SEED)).eval()
    print(f"[model] {CONFIG.relative_to(REPO)}: {kwargs['num_cams']} cams, "
          f"{kwargs['num_frames']} frames, {kwargs['image_hw']}, "
          f"Q={kwargs['num_query']}, C={kwargs['embed_dims']}, "
          f"{cfg['decoder']['num_layers']} layers, D={kwargs['depth_bins']}, "
          f"BEV {kwargs['bev_size']}; "
          f"{sum(p.numel() for p in model.parameters())} parameters")

    max_err, k_ms, p_ms = phase_kernel(model, dev)
    ev, steady, peak, launches = phase_main(model, dev, args.profile)
    phase_reference(model, ev)
    phase_small(dev)
    print(f"[-] {card}: steady streaming step {steady:.2f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(json.dumps({"kernels": [{
        "name": "gather_fold", "route": "cuda",
        "source": "racformer_tpu_torch/csrc/gather_fold.cu",
        "replaces": "racformer_tpu/ops/gather_kernel.py:187",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
