"""The one traffic generator: frames, scene plans and train batches from a
traffic mix's parameters (a JSON file beside this one), a configuration and
a seed. numpy only, so the plain reference and the program get the same
host arrays.

Every seed gets the same sizes in another order: the radar point counts of
the frame pool are evenly spaced over the mix's range and the scene lengths
cycle through every length of its range, each list permuted by the seed; the
GT box counts of a train pool likewise. Only the pixel, point and box values
differ from seed to seed, so the work per frame does not.

A frame follows the port's field contract (`StreamingEvaluator.step`):
uint8 BGR images [N, H, W, 3], radar points [P, 7] (x, y, z, rcs, vx, vy,
time lag) with a validity mask, radar depth / RCS maps in the column form
[N, W] that the nuScenes rasterizer yields, lidar2img / img2lidar [N, 4, 4]
of the configuration's rig, and a scene-relative timestamp.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one seed (any integer, of any size)."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def rig(cfg: dict):
    """(lidar2img, img2lidar) [N, 4, 4] float32 of the configuration's
    cameras: yaw about the ego's z axis, a pinhole of `focal_px`, centred."""
    H, W = cfg["model"]["image_hw"]
    f = float(cfg["rig"]["focal_px"])
    mats = []
    for yaw_deg in cfg["rig"]["camera_yaw_deg"]:
        yaw = np.deg2rad(yaw_deg)
        R = np.array([[-np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, -1.0],
                      [np.cos(yaw), np.sin(yaw), 0.0]], np.float64)
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
        M = np.eye(4)
        M[:3, :3] = K @ R
        mats.append(M)
    l2i = np.stack(mats)
    return l2i.astype(np.float32), np.linalg.inv(l2i).astype(np.float32)


def spaced(lo: int, hi: int, n: int) -> np.ndarray:
    """n integers evenly spaced over [lo, hi)."""
    return (lo + (np.arange(n) * (hi - lo)) // n).astype(np.int64)


def radar(rng, n: int, cap: int, frames: int = 1):
    """[frames, cap, 7] points, the first n of each frame real (the port's
    synthetic layout: x, y over +-50 m, rcs, compensated velocity), and the
    mask."""
    pts = np.zeros((frames, cap, 7), np.float32)
    pts[:, :n, 0:2] = rng.uniform(-50, 50, size=(frames, n, 2))
    pts[:, :n, 3] = rng.uniform(-20, 30, size=(frames, n))
    pts[:, :n, 4:6] = rng.normal(size=(frames, n, 2))
    mask = np.zeros((frames, cap), bool)
    mask[:, :n] = True
    return pts, mask


def column_maps(rng, shape, share: float):
    """Radar depth and RCS maps in column form: a `share` of the columns
    hold one return (depth 1-60 m, RCS -20-30), the rest 0."""
    hit = rng.uniform(size=shape) < share
    depth = np.where(hit, rng.uniform(1, 60, size=shape), 0).astype(np.float32)
    rcs = np.where(hit, rng.uniform(-20, 30, size=shape), 0).astype(np.float32)
    return depth, rcs


def frame_pool(cfg: dict, mix: dict, seed: int) -> list:
    """The mix's pool of distinct frames (without timestamps)."""
    rng = rng_for(seed, 1)
    N = len(cfg["rig"]["camera_yaw_deg"])
    H, W = cfg["model"]["image_hw"]
    cap = cfg["radar"]["max_points"]
    lo, hi = mix["radar_points"]
    counts = rng.permutation(spaced(lo, hi, mix["pool_frames"]))
    l2i, i2l = rig(cfg)
    pool = []
    for n in counts:
        pts, mask = radar(rng, int(n), cap)
        depth, rcs = column_maps(rng, (N, W), mix["radar_column_share"])
        pool.append(dict(
            imgs=rng.integers(0, 256, size=(N, H, W, 3), dtype=np.uint8),
            radar_points=pts[0], radar_mask=mask[0], radar_depth=depth,
            radar_rcs=rcs, lidar2img=l2i, img2lidar=i2l))
    return pool


def scene_lengths(mix: dict, seed: int, stream: int) -> np.ndarray:
    lo, hi = mix["scene_frames"]
    return rng_for(seed, 2, stream).permutation(np.arange(lo, hi + 1))


def tape(mix: dict, seed: int, stream: int, n: int) -> list:
    """The first n frames of one stream: [(pool index, scene start,
    timestamp)]. The stream walks the pool in order from its own offset
    and starts a new scene after each length of its cycle; stream b > 0
    begins b / streams of the way into its first scene, so the streams'
    boundaries are staggered."""
    P, streams = mix["pool_frames"], mix["streams"]
    lengths = scene_lengths(mix, seed, stream)
    dt = float(mix["frame_interval_s"])
    at = stream * P // streams
    into = int(lengths[0]) * stream // streams
    out, k, scene_at = [], 0, 0
    left = int(lengths[0]) - into
    for i in range(n):
        if left == 0:
            k += 1
            left = int(lengths[k % len(lengths)])
            scene_at = i
        out.append(((at + i) % P, i == scene_at, dt * (i - scene_at)))
        left -= 1
    return out


def clear_of_ego(rng, gt: np.ndarray, ego_radius: float) -> None:
    """Redraws, in place, the centre (x, y) of each GT box [G, 9] whose
    footprint's bounding circle (half its w-l diagonal) reaches into the
    circle of `ego_radius` metres round the ego origin, until none does:
    no box overlaps the ego vehicle, where the rig's cameras sit and the
    polar and pinhole maps are singular. A radius of 0 keeps every box."""
    while ego_radius > 0:
        reach = ego_radius + 0.5 * np.hypot(gt[:, 3], gt[:, 4])
        bad = np.hypot(gt[:, 0], gt[:, 1]) < reach
        if not bad.any():
            break
        gt[bad, 0:2] = rng.uniform(-45, 45, size=(int(bad.sum()), 2))


def train_pool(cfg: dict, mix: dict, seed: int) -> list:
    """The mix's pool of train batches: each B samples of T frames, as the
    port's `SyntheticDataset` lays them out (the radar maps in column form
    [B, T, N, W], to be smeared down the columns on the device), with GT box
    counts evenly spaced over the mix's range and permuted by the seed, each
    box clear of the mix's `ego_radius_m` (`clear_of_ego`)."""
    rng = rng_for(seed, 3)
    m = cfg["model"]
    N = len(cfg["rig"]["camera_yaw_deg"])
    T, (H, W), G = m["num_frames"], m["image_hw"], m["max_gt"]
    B, cap = mix["batch"], cfg["radar"]["max_points"]
    lo, hi = mix["gt_boxes"][0], min(mix["gt_boxes"][1], G)
    n_gt = rng.permutation(spaced(lo, hi + 1, mix["pool_batches"] * B))
    n_pts = rng.permutation(spaced(*mix["radar_points"], mix["pool_batches"] * B))
    l2i, i2l = rig(cfg)
    pool = []
    for b in range(mix["pool_batches"]):
        samples = []
        for s in range(B):
            k = b * B + s
            pts, mask = radar(rng, int(n_pts[k]), cap, T)
            g = int(n_gt[k])
            gt = np.zeros((G, 9), np.float32)
            gt[:g, 0:2] = rng.uniform(-45, 45, size=(g, 2))
            gt[:g, 2] = rng.uniform(-2, 1, size=(g,))
            gt[:g, 3:6] = rng.uniform(0.5, 6.0, size=(g, 3))
            gt[:g, 6] = rng.uniform(-np.pi, np.pi, size=(g,))
            clear_of_ego(rng, gt[:g], float(mix.get("ego_radius_m", 0.0)))
            labels = np.zeros((G,), np.int32)
            labels[:g] = rng.integers(0, len(cfg["class_names"]), size=(g,))
            depth, rcs = column_maps(rng, (T, N, W), mix["radar_column_share"])
            samples.append(dict(
                imgs=rng.integers(0, 256, size=(T, N, H, W, 3), dtype=np.uint8),
                radar_points=pts, radar_mask=mask,
                radar_depth=depth, radar_rcs=rcs,
                lidar2img=np.broadcast_to(l2i, (T, N, 4, 4)),
                img2lidar=np.broadcast_to(i2l, (T, N, 4, 4)),
                time_diff=np.arange(T, dtype=np.float32) * float(
                    mix["frame_interval_s"]),
                gt_bboxes=gt, gt_labels=labels, gt_mask=np.arange(G) < g,
                gt_depth=(rng.uniform(2, 60, size=(N, H, W)) * (rng.uniform(
                    size=(N, H, W)) < 0.05)).astype(np.float32)))
        pool.append({k: np.stack([s[k] for s in samples]) for k in samples[0]})
    return pool
