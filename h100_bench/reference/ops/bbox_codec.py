"""Box codecs and polar (theta, d) transforms (port of
`racformer_tpu/ops/bbox_codec.py`).

Box layouts:
  * "raw" 9-dim box:       [cx, cy, cz, w, l, h, yaw, vx, vy]
  * "normalized" 10-dim:   [cx, cy, log w, log l, cz, log h, sin yaw, cos yaw, vx, vy]
  * "encoded" 10-dim:      [nx, ny, nz, log w, log l, log h, sin yaw, cos yaw, vx, vy]
    where nx/ny/nz are pc_range-normalized centers in [0, 1]
  * "polar query" 10-dim:  [theta, d, nz, log w, log l, log h, sin yaw, cos yaw, vx, vy]
    with theta in [0, 1] (angle / 2pi) and d the BEV radius / 65 m.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def _range(pc_range, like: torch.Tensor):
    lo = torch.tensor(pc_range[0:3], dtype=like.dtype, device=like.device)
    hi = torch.tensor(pc_range[3:6], dtype=like.dtype, device=like.device)
    return lo, hi


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """[..., >=7] raw box -> 10-dim (or 8-dim) normalized box."""
    rot = bboxes[..., 6:7]
    parts = [bboxes[..., 0:2], torch.log(bboxes[..., 3:5]), bboxes[..., 2:3],
             torch.log(bboxes[..., 5:6]), torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts.append(bboxes[..., 7:9])
    return torch.cat(parts, dim=-1)


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_bbox`."""
    rot = torch.atan2(normalized[..., 6:7], normalized[..., 7:8])
    parts = [normalized[..., 0:2], normalized[..., 4:5],
             torch.exp(normalized[..., 2:4]), torch.exp(normalized[..., 5:6]),
             rot]
    if normalized.shape[-1] > 8:
        parts.append(normalized[..., 8:10])
    return torch.cat(parts, dim=-1)


def encode_bbox(bboxes: torch.Tensor, pc_range=None) -> torch.Tensor:
    """Raw box -> pc_range-normalized encoded box."""
    xyz = bboxes[..., 0:3]
    if pc_range is not None:
        lo, hi = _range(pc_range, bboxes)
        xyz = (xyz - lo) / (hi - lo)
    rot = bboxes[..., 6:7]
    parts = [xyz, torch.log(bboxes[..., 3:6]), torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts.append(bboxes[..., 7:9])
    return torch.cat(parts, dim=-1)


def decode_bbox(bboxes: torch.Tensor, pc_range=None) -> torch.Tensor:
    """Encoded box -> raw box."""
    xyz = bboxes[..., 0:3]
    if pc_range is not None:
        lo, hi = _range(pc_range, bboxes)
        xyz = xyz * (hi - lo) + lo
    parts = [xyz, torch.exp(bboxes[..., 3:6]),
             torch.atan2(bboxes[..., 6:7], bboxes[..., 7:8])]
    if bboxes.shape[-1] > 8:
        parts.append(bboxes[..., 8:10])
    return torch.cat(parts, dim=-1)


def theta_d_pair_to_xy(theta: torch.Tensor, d: torch.Tensor,
                       map_size: float = 102.4, r: float = 65.0):
    """Separate (theta, d) in, separate clamped normalized (x, y) out."""
    center = map_size / 2.0
    ang = theta * TWO_PI
    rad = d * r
    x = ((center + rad * torch.cos(ang)) / map_size).clamp(0.0, 1.0)
    y = ((center + rad * torch.sin(ang)) / map_size).clamp(0.0, 1.0)
    return x, y


def theta_d_to_xy(theta_d: torch.Tensor, map_size: float = 102.4,
                  r: float = 65.0) -> torch.Tensor:
    """Polar (theta, d) -> normalized BEV (x, y) in [0, 1]; trailing channels
    pass through."""
    x, y = theta_d_pair_to_xy(theta_d[..., 0:1], theta_d[..., 1:2],
                              map_size, r)
    return torch.cat([x, y, theta_d[..., 2:]], dim=-1)


def xy_to_theta_d(xy: torch.Tensor, map_size: float = 102.4, r: float = 65.0,
                  norm: bool = True) -> torch.Tensor:
    """Normalized BEV (x, y) -> polar (theta, d). Inverse of
    :func:`theta_d_to_xy`."""
    if norm:
        dx = xy[..., 0:1] * map_size - map_size / 2.0
        dy = xy[..., 1:2] * map_size - map_size / 2.0
        d = torch.sqrt(dx * dx + dy * dy) / r
        theta = torch.remainder(torch.atan2(dy, dx) + TWO_PI, TWO_PI) / TWO_PI
    else:
        dx, dy = xy[..., 0:1], xy[..., 1:2]
        d = torch.sqrt(dx * dx + dy * dy)
        theta = torch.remainder(torch.atan2(dy, dx) + TWO_PI, TWO_PI)
    return torch.cat([theta, d, xy[..., 2:]], dim=-1)


def rotation_2d_in_bev(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate point offsets [..., P, 3] about +z by per-box yaw [..., 1]."""
    ang = angles[..., 0]
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically clamped logit."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
