"""Radar pillar ops: dense, fixed-shape pillarization on the BEV grid (port
of `racformer_tpu/ops/pillars.py`).

The padded point set [P, C] is reduced straight onto the ny x nx pillar
grid: cluster means by segment sums, the PFN max-pool by `scatter_reduce_`.
The reference's hard-voxelization cap keeps the first `max_pts` points of
each pillar in point order; `cap_pillar_points` reproduces it with a stable
sort and a running max instead of a dynamic [voxels, max_pts, C] tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PillarGrid(NamedTuple):
    pc_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple  # (vx, vy, vz)
    nx: int
    ny: int


def pillar_indices(points_xy: torch.Tensor, mask: torch.Tensor,
                   grid: PillarGrid):
    """points_xy: [P, 2]; mask: [P] bool -> (ids [P] int64 in [0, ny*nx],
    valid [P]); invalid or out-of-range points get the dummy id ny*nx."""
    ix = torch.floor((points_xy[..., 0] - grid.pc_range[0])
                     / grid.voxel_size[0]).long()
    iy = torch.floor((points_xy[..., 1] - grid.pc_range[1])
                     / grid.voxel_size[1]).long()
    valid = mask & (ix >= 0) & (ix < grid.nx) & (iy >= 0) & (iy < grid.ny)
    ids = torch.where(valid, iy * grid.nx + ix,
                      torch.full_like(ix, grid.ny * grid.nx))
    return ids, valid


def cap_pillar_points(ids: torch.Tensor, valid: torch.Tensor, max_pts: int,
                      dummy_id: int) -> torch.Tensor:
    """`valid` with every point whose arrival rank within its pillar is
    >= max_pts turned off."""
    P = ids.shape[0]
    key = torch.where(valid, ids, torch.full_like(ids, dummy_id))
    sk, order = torch.sort(key, stable=True)
    pos = torch.arange(P, device=ids.device)
    is_start = torch.ones_like(valid)
    is_start[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)),
                         dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    return valid & (rank < max_pts)


def augment_pillar_points(points: torch.Tensor, mask: torch.Tensor,
                          grid: PillarGrid, max_pts_per_pillar: int = 0):
    """13-channel PFN input per point: [raw 7 | xyz - cluster mean 3 |
    xyz - pillar center 3]. points: [P, 7]; mask: [P].
    Returns (features [P, 13], ids [P], valid [P])."""
    num_seg = grid.ny * grid.nx + 1
    dummy = grid.ny * grid.nx
    ids, valid = pillar_indices(points[:, :2], mask, grid)
    if max_pts_per_pillar > 0:
        valid = cap_pillar_points(ids, valid, max_pts_per_pillar, dummy)
        ids = torch.where(valid, ids, torch.full_like(ids, dummy))
    vmask = valid[:, None].to(points.dtype)
    xyz = points[:, :3] * vmask
    seg_sum = xyz.new_zeros((num_seg, 3)).index_add_(0, ids, xyz)
    seg_cnt = vmask.new_zeros((num_seg, 1)).index_add_(0, ids, vmask)
    mean = seg_sum / seg_cnt.clamp(min=1.0)
    f_cluster = points[:, :3] - mean[ids]

    vx, vy, vz = grid.voxel_size
    x0, y0, z0 = grid.pc_range[0], grid.pc_range[1], grid.pc_range[2]
    ix = (ids % grid.nx).to(points.dtype)
    iy = ((ids // grid.nx) % grid.ny).to(points.dtype)
    cx = ix * vx + (vx / 2.0 + x0)
    cy = iy * vy + (vy / 2.0 + y0)
    cz = torch.full_like(cx, vz / 2.0 + z0)
    f_center = points[:, :3] - torch.stack([cx, cy, cz], dim=-1)
    feats = torch.cat([points, f_cluster, f_center], dim=-1) * vmask
    return feats, ids, valid


def pillar_bev_features(point_feats: torch.Tensor, ids: torch.Tensor,
                        valid: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """Per-pillar max-pool of point features [P, F] onto the dense canvas
    [ny, nx, F]; empty pillars are 0."""
    num_seg = grid.ny * grid.nx + 1
    F_ = point_feats.shape[-1]
    neg = torch.finfo(point_feats.dtype).min
    data = torch.where(valid[:, None], point_feats,
                       torch.full_like(point_feats, neg))
    pooled = point_feats.new_full((num_seg, F_), neg)
    pooled.scatter_reduce_(0, ids[:, None].expand(-1, F_), data, "amax",
                           include_self=True)
    cnt = torch.zeros(num_seg, dtype=torch.int64, device=ids.device)
    cnt.index_add_(0, ids, valid.long())
    pooled = torch.where(cnt[:, None] > 0, pooled, torch.zeros_like(pooled))
    return pooled[:-1].reshape(grid.ny, grid.nx, F_)
