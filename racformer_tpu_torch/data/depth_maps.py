"""Host-side depth / RCS map rasterization (numpy).

Matches the reference pipeline rasterizers
(the reference's `loaders/pipelines/loading.py:469-515` PointToMultiViewDepth,
`:517-601` RadarPointToMultiViewDepth): project points through lidar2img,
keep the nearest depth per pixel; the radar rasterizer deliberately writes
whole *columns* (radar has no elevation) for both depth and RCS.

A copy of `racformer_tpu/data/depth_maps.py` (the port imports nothing of
the JAX package); `tests/test_torch_data.py` holds the copy equal to its
original.
"""

from __future__ import annotations

import numpy as np


def project_to_image(points_xyz: np.ndarray, lidar2img: np.ndarray, eps=1e-5):
    """points: [P, 3]; lidar2img: [4, 4] -> (u, v, depth) each [P]."""
    hom = np.concatenate([points_xyz, np.ones_like(points_xyz[:, :1])], axis=1)
    cam = hom @ lidar2img.T
    depth = cam[:, 2]
    uv = cam[:, :2] / np.maximum(depth[:, None], eps)
    return uv[:, 0], uv[:, 1], depth


def points_to_depth_map(points_xyz, lidar2img, hw, d_range=(1.0, 65.0)):
    """Sparse nearest-wins depth map [H, W] (0 = missing)."""
    H, W = hw
    u, v, d = project_to_image(points_xyz, lidar2img)
    ui, vi = np.round(u).astype(np.int64), np.round(v).astype(np.int64)
    keep = (
        (d >= d_range[0]) & (d < d_range[1])
        & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    )
    ui, vi, d = ui[keep], vi[keep], d[keep]
    depth_map = np.zeros((H, W), np.float32)
    if len(d) == 0:
        return depth_map
    # nearest-depth-wins: sort descending so closest writes last
    order = np.argsort(-d)
    depth_map[vi[order], ui[order]] = d[order]
    return depth_map


def radar_to_depth_rcs_maps(points, lidar2img, hw, d_range=(1.0, 65.0)):
    """Radar points [P, >=4] (x, y, z, rcs, ...) -> (depth [H, W], rcs [H, W]).

    Writes whole columns per hit (`loading.py:547-548` — the deliberate
    no-elevation smear). rcs map initialized to -1e3 where missing.
    """
    H, W = hw
    depth_map = np.zeros((H, W), np.float32)
    rcs_map = np.full((H, W), -1000.0, np.float32)
    if len(points) == 0:
        return depth_map, rcs_map
    u, v, d = project_to_image(points[:, :3], lidar2img)
    ui = np.round(u).astype(np.int64)
    keep = (d >= d_range[0]) & (d < d_range[1]) & (ui >= 0) & (ui < W)
    ui, d, rcs = ui[keep], d[keep], points[keep, 3]
    if len(d) == 0:
        return depth_map, rcs_map
    order = np.argsort(-d)
    depth_map[:, ui[order]] = d[order][None, :]
    rcs_map[:, ui[order]] = rcs[order][None, :]
    return depth_map, rcs_map
