"""Streaming inference with a per-frame feature cache on the device (port of
`racformer_tpu/eval/streaming.py`).

The cache is a T-frame window of encoded features (newest frame at index 0):
the level-concatenated image pyramid, the LSS and radar BEV maps, the
lidar2img matrices and the timestamps. Each step encodes only the new frame,
shifts the window, decodes it and decodes the boxes. The first frame of a
scene fills the whole window (the reference pads missing history with the
first frame).

`step` is the single-stream latency protocol; `step_batch` runs B
independent scene streams in lockstep, with per-stream scene resets inside
the step, and `run_multistream` drives it over a dataset (the throughput
protocol). Both steps shift the window through the one `_window` function,
so B = 1 lockstep equals `step()` exactly.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..model.racformer import RaCFormer, preprocess_images
from .decode import decode_boxes, decode_config
from ..utils import distributed, tracing
from .offline import gather_gt_sample, synchronize

FIELDS = ("imgs", "radar_points", "radar_mask", "radar_depth", "radar_rcs",
          "lidar2img", "img2lidar")


def _check_relative(ts_max: float):
    if ts_max > 1e6:
        raise ValueError(
            "timestamp looks absolute (epoch seconds); pass scene-relative "
            "seconds: float32 on the device cannot resolve sub-second deltas "
            "at ~1e9 magnitudes (its ULP there is 128 s)")


class StreamingEvaluator:
    def __init__(self, model: RaCFormer, eval_cfg: Optional[Dict] = None):
        self.model = model
        self.T = model.num_frames
        self.device = next(model.parameters()).device
        # (feat_cat, lss, radar, lidar2img, ts), each [B, T, ...]
        self.cache = None
        self.decode_cfg = decode_config(eval_cfg)
        self.steps = 0  # steps made: the step id of their spans

    def reset(self):
        """Call at scene boundaries (a new scene must not see old frames)."""
        self.cache = None

    def _window(self, new: torch.Tensor, old: Optional[torch.Tensor],
                reset: Optional[torch.Tensor]):
        """[B, ...] newest frame + [B, T, ...] window -> the shifted window.
        A stream whose `reset` is True (every stream when there is no
        window yet) restarts from the new frame, duplicated across the
        window."""
        boot = new[:, None].expand(new.shape[0], self.T, *new.shape[1:])
        if old is None:
            return boot.contiguous()
        shifted = torch.cat([new[:, None], old[:, : self.T - 1]], dim=1)
        if reset is None:
            return shifted
        return torch.where(reset.view(-1, *(1,) * (shifted.dim() - 1)), boot,
                           shifted)

    @torch.no_grad()
    def _advance(self, t: Dict[str, torch.Tensor], ts: torch.Tensor,
                 reset: Optional[torch.Tensor]) -> Dict:
        """Encode the newest frame of each stream (`t`: FIELDS as [B, ...]
        tensors on the device, `ts`: [B] float32 scene-relative seconds),
        shift the windows, decode them and decode the boxes."""
        with tracing.span("eval.encode_frame"):
            imgs = preprocess_images(t["imgs"])
            H = imgs.shape[2]
            radar = []
            for key in ("radar_depth", "radar_rcs"):
                m = t[key].float()
                if m.dim() == 3:  # column form [B, N, W]: the rasterizer smears
                    m = m[:, :, None, :].expand(m.shape[0], m.shape[1], H,  # columns
                                                m.shape[2])
                radar.append(m)
            feat_cat, lss, rbev, _ = self.model.encode_frame(
                imgs, t["radar_points"].float(), t["radar_mask"].bool(), radar[0],
                radar[1], t["img2lidar"].float())
            new = (feat_cat, lss, rbev, t["lidar2img"].float(), ts)
        with tracing.span("eval.window"):
            if self.cache is None and reset is not None:
                # the multi-stream window, sized from the first encode; never
                # read: every stream resets on its first step
                self.cache = tuple(x.new_zeros((x.shape[0], self.T, *x.shape[1:]))
                                   for x in new)
            old = self.cache or (None,) * len(new)
            self.cache = tuple(self._window(n, o, reset) for n, o in zip(new, old))
        with tracing.span("eval.decode_window"):
            cat_w, lss_w, radar_w, l2i_w, ts_w = self.cache
            outs = self.model.decode_window(cat_w, lss_w, radar_w, l2i_w,
                                            ts_w[:, :1] - ts_w)
        with tracing.span("eval.decode_boxes"):
            return decode_boxes(outs["all_cls_scores"][-1],
                                outs["all_bbox_preds"][-1], **self.decode_cfg)

    def _result(self, out: Dict, blocking: bool) -> Dict:
        if not blocking:
            return out
        with tracing.span("eval.result"):
            return {k: v.cpu().numpy() for k, v in out.items()}

    def step(self, frame: Dict, blocking: bool = True) -> Dict:
        """frame: imgs [N, H, W, 3] (raw 0-255, uint8 preferred), radar_points
        [P, 7], radar_mask [P], radar_depth / radar_rcs [N, H, W] dense maps
        or [N, W] column maps, lidar2img [N, 4, 4], img2lidar [N, 4, 4], and
        timestamp (float seconds RELATIVE to the scene start).

        Returns the decoded boxes of the current frame with a leading axis
        of 1: numpy arrays when `blocking`, device tensors otherwise."""
        self.steps += 1
        with tracing.span("eval.step", step=self.steps, frames=1):
            _check_relative(abs(float(frame["timestamp"])))
            dev = self.device
            with tracing.span("eval.upload"):
                t = _upload({k: torch.as_tensor(np.asarray(frame[k]))
                             for k in FIELDS}, dev)
                t = {k: v[None] for k, v in t.items()}
                ts = torch.tensor([float(frame["timestamp"])],
                                  dtype=torch.float32, device=dev)
            return self._result(self._advance(t, ts, None), blocking)

    def step_batch(self, frames, resets: Sequence[bool],
                   blocking: bool = True) -> Dict:
        """Lockstep B independent scene streams (one frame each per call).

        frames: either B per-stream dicts with the `step()` field contract
        (each timestamp scene-relative to ITS stream's scene start), or ONE
        pre-batched dict whose values carry a leading [B] axis; its tensors
        may already lie on the device and stay there (only the B timestamps
        are read on the host, for the check that they are scene-relative).
        resets: B bools, True when that stream starts a new scene this step
        (frame 0 of every stream included). Returns the decoded dict with
        leading batch axis B."""
        dev = self.device
        self.steps += 1
        with tracing.span("eval.step", step=self.steps, frames=len(resets)):
            with tracing.span("eval.upload"):
                if isinstance(frames, dict):
                    ts = torch.as_tensor(frames["timestamp"]).to(dev, torch.float32)
                    _check_relative(float(ts.abs().max()))
                    t = _upload({k: torch.as_tensor(frames[k]) for k in FIELDS},
                                dev)
                else:
                    _check_relative(max(abs(float(f["timestamp"])) for f in frames))
                    t = _upload({k: torch.from_numpy(
                        np.stack([np.asarray(f[k]) for f in frames]))
                        for k in FIELDS}, dev)
                    ts = torch.tensor([float(f["timestamp"]) for f in frames],
                                      dtype=torch.float32, device=dev)
                if self.cache is None and not all(resets):
                    raise ValueError("every stream must reset on its first step")
                reset = torch.tensor([bool(r) for r in resets], device=dev)
            return self._result(self._advance(t, ts, reset), blocking)


def _upload(host: Dict[str, torch.Tensor], dev) -> Dict[str, torch.Tensor]:
    """The tensors on `dev`; the bytes of those in host memory (what a
    CUDA device is sent) are counted as the open span's `h2d_bytes`."""
    if tracing.recording():
        tracing.count("h2d_bytes", sum(x.nbytes for x in host.values()
                                       if not x.is_cuda))
    return {k: x.to(dev) for k, x in host.items()}


def sample_timestamp(sample: Dict, idx: int) -> float:
    """Absolute sample time in seconds; datasets without timestamps get the
    nuScenes keyframe cadence (2 Hz) so time_diff stays non-degenerate."""
    return float(sample.get("timestamp", idx * 0.5))


def prepare_frame(sample: Dict, ts_rel: float, use_radar_cols: bool) -> Dict:
    """Per-frame field prep shared by the eval driver's single-stream loop
    and the multi-stream runner: uint8-ify raw images (pipeline-native, 4x
    cheaper to upload), shrink column-constant radar maps to their [N, W]
    payload. `ts_rel` is the scene-relative timestamp, rebased by the caller
    in float64 (epoch-second float32 ULP is 128 s)."""
    imgs = sample["imgs"][0]
    if imgs.dtype != np.uint8 and imgs.max() > 1.0:
        imgs = np.clip(np.round(imgs), 0, 255).astype(np.uint8)
    rd, rr = sample["radar_depth"][0], sample["radar_rcs"][0]
    if use_radar_cols:
        rd, rr = rd[:, 0, :], rr[:, 0, :]
    return dict(
        imgs=imgs, radar_points=sample["radar_points"][0],
        radar_mask=sample["radar_mask"][0],
        radar_depth=rd, radar_rcs=rr,
        lidar2img=sample["lidar2img"][0],
        img2lidar=sample["img2lidar"][0],
        timestamp=ts_rel,
    )


def radar_maps_are_columns(sample: Dict) -> bool:
    """Column-constancy is a static property of the rasterizer
    (`data/depth_maps.py::radar_to_depth_rcs_maps` writes whole columns);
    decide once on one sample. Synthetic fixtures are dense and keep the
    [N, H, W] form."""
    rd, rr = sample["radar_depth"][0], sample["radar_rcs"][0]
    return bool(np.all(rd == rd[:, :1, :]) and np.all(rr == rr[:, :1, :]))


def _scene_groups(dataset) -> List[List[int]]:
    """Consecutive-run scene grouping from cheap metadata (`dataset.infos`
    scene tokens: loading samples just to read their scene id would decode
    every image twice). Datasets without scene metadata are one group."""
    n = len(dataset)
    infos = getattr(dataset, "infos", None)
    if infos is None:
        return [list(range(n))]
    groups, cur, prev = [], [], object()
    for i in range(n):
        tok = str(infos[i].get("scene_token", ""))
        if tok != prev and cur:
            groups.append(cur)
            cur = []
        cur.append(i)
        prev = tok
    if cur:
        groups.append(cur)
    return groups


def _assign_streams(groups: List[List[int]], streams: int,
                    ) -> List[List[List[int]]]:
    """Greedy longest-scene-first onto the least-loaded stream (scenes are
    independent, so per-stream scene order is free). A single giant group
    (no scene metadata) is split contiguously: the throughput protocol must
    insert stream boundaries somewhere."""
    if len(groups) == 1 and streams > 1:
        g = groups[0]
        k = (len(g) + streams - 1) // streams
        groups = [g[i: i + k] for i in range(0, len(g), k)]
    out: List[List[List[int]]] = [[] for _ in range(streams)]
    load = [0] * streams
    for g in sorted(groups, key=len, reverse=True):
        b = int(np.argmin(load))
        out[b].append(g)
        load[b] += len(g)
    return out


def run_single_stream(ev: StreamingEvaluator, dataset):
    """Latency protocol: one `step()` per sample in dataset order, the cache
    reset at scene boundaries, timestamps rebased to each scene's start in
    float64 before the device's float32.

    Returns (preds, gts, fps) as `run_multistream` does; fps leaves out the
    first step."""
    preds, gts = [], []
    t_total, n = 0.0, 0
    prev_scene, use_radar_cols, scene_t0 = None, None, 0.0
    for i in range(len(dataset)):
        s = dataset[i]
        scene = s.get("scene", None)
        ts_abs = sample_timestamp(s, i)
        if scene is not None and scene != prev_scene:
            if prev_scene is not None:
                ev.reset()
            prev_scene = scene
            scene_t0 = ts_abs
        elif scene is None and i == 0:
            scene_t0 = ts_abs
        if use_radar_cols is None:
            use_radar_cols = radar_maps_are_columns(s)
        frame = prepare_frame(s, ts_abs - scene_t0, use_radar_cols)
        t0 = time.perf_counter()
        out = ev.step(frame, blocking=False)
        synchronize(ev.device)
        if i > 0:
            t_total += time.perf_counter() - t0
            n += 1
        preds.append({k: v[0].cpu().numpy() for k, v in out.items()})
        g = gather_gt_sample(s)
        if g is not None:
            gts.append(g)
    return preds, gts, (n / t_total if t_total > 0 else 0.0)


def run_multistream(ev: StreamingEvaluator, dataset, streams: int):
    """Throughput protocol: `streams` independent scene streams in lockstep
    through `StreamingEvaluator.step_batch` (the B = 1 `step()` loop of the
    eval driver stays the latency protocol). Exhausted streams re-feed their
    last frame (output discarded) until the longest stream drains, so the
    batch keeps its shape.

    With W ranks (`utils.distributed`) and a stream count that W divides,
    rank r runs streams [r * N / W, (r + 1) * N / W) of the one stream plan,
    as the JAX evaluator shards the stream axis over its data mesh, and
    every rank returns all predictions. With another count rank 0 runs
    every stream (`val.py`'s warning is printed) and the other ranks return
    at once with no predictions: none of them waits in a collective for
    rank 0's whole run.

    Returns (preds ordered by dataset index, gts likewise, fps) where fps
    counts VALID frames only, after the first step (with several ranks:
    the frames of all of them over the slowest rank's time).
    """
    n = len(dataset)
    plan = _assign_streams(_scene_groups(dataset), streams)
    # drop streams that were assigned no scene (more streams than scene
    # groups): an empty stream has no frame to re-feed
    plan = [p for p in plan if p]
    if n == 0 or not plan:
        return [], [], 0.0
    if len(plan) < streams:
        print(f"streaming: only {len(plan)} scene groups — running "
              f"{len(plan)} streams instead of the requested {streams}")
        streams = len(plan)
    world, rank = distributed.world(), distributed.rank()
    shard = world > 1 and streams % world == 0
    if shard:
        k = streams // world
        plan = plan[rank * k:(rank + 1) * k]
    elif world > 1:
        if rank != 0:
            return [], [], 0.0
        print(f"warning: --streams {streams} not a multiple of the world "
              f"size {world}; running all streams on one rank (pass a "
              f"multiple of {world} to shard over the ranks)")
    preds_by_idx, gts_by_idx, n_timed, t_total = _lockstep(ev, dataset, plan)
    if shard:
        parts = distributed.all_gather_object(
            (preds_by_idx, gts_by_idx, n_timed, t_total))
        preds_by_idx = {i: p for part in parts for i, p in part[0].items()}
        gts_by_idx = {i: g for part in parts for i, g in part[1].items()}
        n_timed = sum(part[2] for part in parts)
        t_total = max(part[3] for part in parts)
    assert len(preds_by_idx) == n, (len(preds_by_idx), n)
    preds = [preds_by_idx[i] for i in range(n)]
    gts = [gts_by_idx[i] for i in range(n)] if gts_by_idx else []
    fps = n_timed / t_total if t_total > 0 else 0.0
    return preds, gts, fps


def _lockstep(ev: StreamingEvaluator, dataset, plan):
    """The streams of `plan` (each a list of scene groups) in lockstep.
    Returns ({index: pred}, {index: gt}, valid frames timed, seconds)."""
    streams = len(plan)
    preds_by_idx: Dict[int, Dict] = {}
    gts_by_idx: Dict[int, Dict] = {}
    if not plan:
        return preds_by_idx, gts_by_idx, 0, 0.0
    # flat per-stream (index, is_scene_start) tapes
    tapes = [[(i, j == 0) for g in sgroups for j, i in enumerate(g)]
             for sgroups in plan]
    max_len = max(len(t) for t in tapes)

    use_cols: Optional[bool] = None
    scene_t0 = [0.0] * streams
    last_frame: List[Optional[Dict]] = [None] * streams
    t_total, n_timed = 0.0, 0

    for t in range(max_len):
        frames, resets, valid_idx = [], [], []
        for b in range(streams):
            tape = tapes[b]
            if t < len(tape):
                idx, is_start = tape[t]
                s = dataset[idx]
                if use_cols is None:
                    use_cols = radar_maps_are_columns(s)
                ts_abs = sample_timestamp(s, idx)
                if is_start:
                    scene_t0[b] = ts_abs
                f = prepare_frame(s, ts_abs - scene_t0[b], use_cols)
                last_frame[b] = f
                frames.append(f)
                resets.append(is_start)
                valid_idx.append(idx)
                g = gather_gt_sample(s)
                if g is not None:
                    gts_by_idx[idx] = g
            else:
                frames.append(last_frame[b])
                resets.append(False)
                valid_idx.append(None)
        t0 = time.perf_counter()
        out = ev.step_batch(frames, resets, blocking=False)
        synchronize(ev.device)
        if t > 0:
            t_total += time.perf_counter() - t0
            n_timed += sum(i is not None for i in valid_idx)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for b, idx in enumerate(valid_idx):
            if idx is not None:
                preds_by_idx[idx] = {k: v[b] for k, v in out.items()}

    return preds_by_idx, gts_by_idx, n_timed, t_total
