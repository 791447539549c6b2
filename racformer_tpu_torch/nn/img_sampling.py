"""Image-branch radial spatio-temporal sampling (port of
`racformer_tpu/nn/img_sampling.py`): learned box-anchored 3D offsets
(depth x groups x points), per-frame velocity warp, per-layer shrinking
radial perturbation, projection into every camera of every frame and the
multi-level gather over the level-concatenated pyramid. Its layers run in
float32 whatever the head's dtype, as the JAX package pins them."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import device_constant
from ..ops.bbox_codec import theta_d_pair_to_xy, theta_d_to_xy, xy_to_theta_d
from ..ops.bilinear import PAD
from ..ops.sampling import make_sample_points, sample_image_features
from .bev_sampling import radial_offsets
from .layers import Linear


def concat_geometry(image_hw, num_levels: int):
    """Geometry of the level-concatenated sampler-ready map built by
    `RaCFormer._trunk`: (true_hws, roffs, rcat), level l of camera n starting
    at row n * rcat + roffs[l]."""
    hws = [(image_hw[0] // (4 << l), image_hw[1] // (4 << l))
           for l in range(num_levels)]
    r0s = [h + 2 * PAD - 1 for h, _ in hws]
    return hws, [sum(r0s[:l]) for l in range(num_levels)], sum(r0s)


class ImageRadialSampling(nn.Module):
    def __init__(self, embed_dims: int = 256, num_frames: int = 8,
                 num_groups: int = 4, num_points: int = 4, num_levels: int = 4,
                 depth_num: int = 3,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)):
        super().__init__()
        self.num_frames, self.num_groups, self.num_points = num_frames, num_groups, num_points
        self.num_levels, self.depth_num = num_levels, depth_num
        self.pc_range = tuple(pc_range)
        D, G, P, L = depth_num, num_groups, num_points, num_levels
        f32 = torch.float32
        self.sampling_offset = Linear(embed_dims, D * G * P * 3, dtype=f32)
        self.ray_points_offset = Linear(embed_dims, D, dtype=f32)
        self.scale_weights = Linear(embed_dims, G * num_frames * D * P * L,
                                    dtype=f32)

    def forward(self, query_ray, query_feat, feat_cat, lidar2img, time_diff,
                image_hw, d_region, fold=True):
        """query_ray: [B, Q, 10] polar; feat_cat: [B, T, G, N, rcat, Wmax, 2c];
        lidar2img: [B, T, N, 4, 4]; time_diff: [B, T]; fold: the fold
        gather in eval mode (else every point is sampled).
        Returns [B, Q, G, T*P*D, c]."""
        B, Q, _ = query_ray.shape
        T, G, P, D, L = (self.num_frames, self.num_groups, self.num_points,
                         self.depth_num, self.num_levels)
        off = self.sampling_offset(query_feat).reshape(B, Q, G * P * D, 3)
        pts = make_sample_points(theta_d_to_xy(query_ray), off, self.pc_range)
        vel = query_ray[..., 8:10].detach()
        dist = vel[:, :, None, :] * time_diff[:, None, :, None]  # [B, Q, T, 2]
        xy = pts[:, :, None, :, 0:2] - dist[:, :, :, None, :]
        z = pts[:, :, None, :, 2:3].expand(B, Q, T, G * P * D, 1)
        lo = device_constant(self.pc_range[0:2], xy.device)
        hi = device_constant(self.pc_range[3:5], xy.device)
        td = xy_to_theta_d(torch.cat([(xy - lo) / (hi - lo), z], dim=-1))
        d_off = radial_offsets(query_feat, self.ray_points_offset, d_region, D)
        theta = td[..., 0].reshape(B, Q, T, G, P * D)
        dd = (td[..., 1].reshape(B, Q, T, G, P, D)
              + d_off[:, :, None, None, None, :]).reshape(B, Q, T, G, P * D)
        bxn, byn = theta_d_pair_to_xy(theta, dd)
        bx = bxn * (hi[0] - lo[0]) + lo[0]
        by = byn * (hi[1] - lo[1]) + lo[1]
        sample_points = torch.stack(
            [bx, by, z.reshape(B, Q, T, G, P * D)], dim=-1)

        w = self.scale_weights(query_feat).reshape(B, Q, G, T, D * P, L)
        w = torch.softmax(w, dim=-1)
        return sample_image_features(
            sample_points, feat_cat, w, lidar2img, image_hw[0], image_hw[1],
            concat_geometry(image_hw, L), fold=fold and not self.training)
