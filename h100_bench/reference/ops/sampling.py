"""Box-anchored sample points and their projection into the multi-view,
multi-frame image pyramid (port of `racformer_tpu/ops/sampling.py`:
`make_sample_points`, `project_points_to_views(packed=False)` and
`sample_image_features` over the level-concatenated map, with the eval
path's fold gather or the training path's per-level sample).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .bbox_codec import decode_bbox, rotation_2d_in_bev
from .msmv import msmv_sample_fold, msmv_sample_levels


def make_sample_points(query_bbox: torch.Tensor, offset: torch.Tensor,
                       pc_range) -> torch.Tensor:
    """query_bbox: [B, Q, 10] encoded box; offset: [B, Q, P, 3] box-relative.
    Returns absolute sample points [B, Q, P, 3]."""
    box = decode_bbox(query_bbox, pc_range)
    delta = offset * box[:, :, None, 3:6]
    delta = rotation_2d_in_bev(delta, box[..., 6:7])
    return box[:, :, None, 0:3] + delta


def project_points_to_views(points: torch.Tensor, lidar2img: torch.Tensor,
                            image_h: int, image_w: int, eps: float = 1e-5):
    """points: [B, T, Q, P, 3]; lidar2img: [B, T, N, 4, 4].

    Returns (x, y, view), each [B, T, Q, P]: the normalized coordinates in
    the first camera that sees the point (view int32). A point no camera
    sees gets view 0 and a location outside [0, 1], which samples zero."""
    N = lidar2img.shape[2]
    cam = torch.einsum("btnij,btqpj->btnqpi", lidar2img[..., :3, :3], points)
    cam = cam + lidar2img[:, :, :, None, None, :3, 3]
    homo = cam[..., 2]
    denom = homo.clamp(min=eps)
    x_norm = cam[..., 0] / denom / image_w
    y_norm = cam[..., 1] / denom / image_h
    valid = ((homo > eps) & (x_norm > 0.0) & (x_norm < 1.0)
             & (y_norm > 0.0) & (y_norm < 1.0))  # [B, T, N, Q, P]
    view = valid.to(torch.uint8).argmax(dim=2)  # first valid camera
    oh = (torch.arange(N, device=points.device)[None, None, :, None, None]
          == view[:, :, None]).to(x_norm.dtype)
    return (x_norm * oh).sum(2), (y_norm * oh).sum(2), view.to(torch.int32)


def sample_image_features(
    sample_points: torch.Tensor,
    feat_cat: torch.Tensor,
    scale_weights: torch.Tensor,
    lidar2img: torch.Tensor,
    image_h: int,
    image_w: int,
    cat_geom: tuple,
    fold: bool = True,
) -> torch.Tensor:
    """sample_points: [B, Q, T, G, P, 3] lidar-frame points; feat_cat:
    [B, T, G, N, rcat, Wmax, 2C] level-concatenated sampler-ready pyramid;
    scale_weights: [B, Q, G, T, P, L]; lidar2img: [B, T, N, 4, 4];
    cat_geom: (true_hws, roffs, rcat) of the concatenated map; fold: the
    eval path's fold gather (K1, no gradient), else the training path's
    per-level sample (`msmv_sample_levels`).

    Returns [B, Q, G, T*P, C]."""
    B, Q, T, G, P, _ = sample_points.shape
    L = scale_weights.shape[-1]
    C = feat_cat.shape[-1] // 2
    pts = sample_points.permute(0, 2, 1, 3, 4, 5).reshape(B, T, Q, G * P, 3)
    lx, ly, lv = project_points_to_views(pts, lidar2img, image_h, image_w)

    def to_slabs(a):  # [B, T, Q, G*P] -> [B*T*G, Q, P]
        return a.reshape(B, T, Q, G, P).permute(0, 1, 3, 2, 4).reshape(
            B * T * G, Q, P)

    # the reference orders the weight slabs (B, G, T) while features and
    # locations use (B, T, G) (`sparsebev_sampling.py:113-120`); the trained
    # checkpoint absorbed it, so it is reproduced as is
    w = scale_weights.permute(0, 2, 3, 1, 4, 5).reshape(B * G * T, Q, P, L)
    hws, roffs, rcat = cat_geom
    feats = feat_cat.reshape(B * T * G, *feat_cat.shape[3:])
    sample = msmv_sample_fold if fold else msmv_sample_levels
    out = sample(feats, to_slabs(lx), to_slabs(ly), to_slabs(lv), w, hws,
                 roffs, rcat)
    out = out.reshape(B, T, G, Q, P, C).permute(0, 3, 2, 1, 4, 5)
    return out.reshape(B, Q, G, T * P, C)
