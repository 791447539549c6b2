"""BEV sampling branches (port of `racformer_tpu/nn/bev_sampling.py`):
radial sample points over the temporal BEV queue (box-anchored 2D offsets,
per-frame velocity warp, per-layer shrinking radial perturbation) and the
cross-frame deformable attention with learned per-frame queue weights.

The value projection and positional encoding are the same in every
weight-shared decoder iteration, so `BEVSampling.project_value` runs once
per window, before the iterations, and builds the head-major sampler-ready
value map the fold gather reads.

The value projection, its positional encoding and the output projection
run in `dtype` (the head's); the sampling offsets, radial shifts, scale
weights and the per-frame queue weights in float32, as the JAX package
pins them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.bbox_codec import theta_d_pair_to_xy, theta_d_to_xy, xy_to_theta_d
from ..ops.bilinear import sampler_ready
from ..ops.deform_attn import deform_attn_single_level
from ..ops.sampling import make_sample_points
from .layers import Dropout, Linear, flax_add
from .positional import LearnedPositionalEncoding2D


def radial_offsets(query_feat, ray_offset_dense, d_region, depth_num):
    """Per-depth radial perturbations: linspace(-d, d, D) plus a learned
    sub-bin shift. Returns [B, Q, D]."""
    lin = torch.linspace(-1.0, 1.0, depth_num,
                         device=query_feat.device) * d_region
    shift = (torch.sigmoid(ray_offset_dense(query_feat)) * 2.0 - 1.0) * (
        d_region / depth_num / 2.0)
    return lin[None, None, :] + shift


class BEVCrossFrameAttention(nn.Module):
    """Deformable attention over the T-frame BEV queue, batch-major
    (b * T + t) slab order throughout. Eval mode sums `fold` points per
    kernel output (K1); train mode samples each point (`patch_sample_op`)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 4,
                 num_frames: int = 8, fold: int = 4, spatial_shape=(128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.num_frames, self.fold = num_heads, num_frames, fold
        self.spatial_shape = tuple(spatial_shape)
        self.dtype = dtype
        self.value_proj = Linear(embed_dims, embed_dims, dtype=dtype)
        self.bev_queue_weight = Linear(embed_dims, num_frames,
                                       dtype=torch.float32)
        self.output_proj = Linear(embed_dims, embed_dims, dtype=dtype)
        self.dropout = Dropout(0.1)

    def forward(self, query, value, loc_x, loc_y, weights, fold=True):
        """query: [B, Q, C]; value: [B*T, M, H+3, W+4, 2c] sampler-ready;
        loc_x / loc_y / weights: [B, Q, M, T, P] (loc in [0, 1]); fold:
        the fold gather in eval mode (else every point is sampled)."""
        B, Q, C = query.shape
        T, M = self.num_frames, self.num_heads

        def slabs(a):  # [B, Q, M, T, P] -> [B*T, Q, M, P]
            return a.permute(0, 3, 1, 2, 4).reshape(B * T, Q, M, -1)

        out = deform_attn_single_level(value, slabs(loc_x), slabs(loc_y),
                                       slabs(weights), self.spatial_shape,
                                       self.fold if fold and not self.training
                                       else 0)
        out = out.reshape(B, T, Q, C)
        qw = torch.softmax(self.bev_queue_weight(query), dim=-1)
        out = torch.einsum("btqc,bqt->bqc", out.float(), qw).to(self.dtype)
        return flax_add(self.dropout(self.output_proj(out)), query, self.dtype)


class BEVSampling(nn.Module):
    def __init__(self, embed_dims: int = 256, num_frames: int = 8,
                 num_heads: int = 4, num_points: int = 4, depth_num: int = 5,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 spatial_shape=(128, 128), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_frames, self.num_heads = num_frames, num_heads
        self.num_points, self.depth_num = num_points, depth_num
        self.pc_range = tuple(pc_range)
        self.spatial_shape = tuple(spatial_shape)
        D, M, P = depth_num, num_heads, num_points
        f32 = torch.float32
        self.sampling_offset = Linear(embed_dims, D * M * P * 2, dtype=f32)
        self.ray_points_offset = Linear(embed_dims, D, dtype=f32)
        self.scale_weights = Linear(embed_dims, M * D * P, dtype=f32)
        self.positional_encoding = LearnedPositionalEncoding2D(
            embed_dims // 2, spatial_shape[0], spatial_shape[1], dtype)
        # the fold gather sums `num_points` consecutive points per output
        self.attention = BEVCrossFrameAttention(
            embed_dims, num_heads, num_frames, fold=num_points,
            spatial_shape=spatial_shape, dtype=dtype)

    def project_value(self, bev: torch.Tensor, gather_dtype: torch.dtype):
        """bev: [B, T, H, W, C] -> sampler-ready head-major value map
        [B*T, M, H+3, W+4, 2c] in `gather_dtype`."""
        B, T, H, W, C = bev.shape
        pos = self.positional_encoding(H, W)
        v = self.attention.value_proj(bev + pos[None, None])
        M = self.num_heads
        v = v.to(gather_dtype).reshape(B * T, H, W, M, C // M)
        return sampler_ready(v.permute(0, 3, 1, 2, 4))

    def forward(self, query_ray, query_feat, bev_value, time_diff, d_region,
                fold=True):
        """query_ray: [B, Q, 10] polar; query_feat: [B, Q, C]; bev_value from
        `project_value`; time_diff: [B, T]; d_region: float; fold: the
        fold gather in eval mode (else every point is sampled)."""
        B, Q, _ = query_ray.shape
        T, M, P, D = self.num_frames, self.num_heads, self.num_points, self.depth_num
        off = self.sampling_offset(query_feat).reshape(B, Q, M * P * D, 2)
        off3 = torch.cat([off, torch.zeros_like(off[..., :1])], dim=-1)
        pts = make_sample_points(theta_d_to_xy(query_ray), off3, self.pc_range)
        vel = query_ray[..., 8:10].detach()
        dist = vel[:, :, None, :] * time_diff[:, None, :, None]  # [B, Q, T, 2]
        xy = pts[:, :, None, :, 0:2] - dist[:, :, :, None, :]
        lo = torch.tensor(self.pc_range[0:2], device=xy.device)
        hi = torch.tensor(self.pc_range[3:5], device=xy.device)
        td = xy_to_theta_d((xy - lo) / (hi - lo))  # [B, Q, T, MPD, 2]
        d_off = radial_offsets(query_feat, self.ray_points_offset, d_region, D)
        theta = td[..., 0].reshape(B, Q, T, M, P * D)
        dd = (td[..., 1].reshape(B, Q, T, M, P, D)
              + d_off[:, :, None, None, None, :]).reshape(B, Q, T, M, P * D)
        loc_x, loc_y = theta_d_pair_to_xy(theta, dd)
        loc_x = loc_x.permute(0, 1, 3, 2, 4)  # [B, Q, M, T, PD]
        loc_y = loc_y.permute(0, 1, 3, 2, 4)
        w = self.scale_weights(query_feat).reshape(B, Q, M, 1, D * P)
        w = torch.softmax(w, dim=-1).expand(B, Q, M, T, D * P)
        return self.attention(query_feat, bev_value, loc_x, loc_y, w, fold)
