"""Radar pillar branch (port of `racformer_tpu/nn/pillar_encoder.py`):
PillarFeatureNet (7 channels + cluster and center offsets -> 64) with the
per-pillar max-pool onto the 128 x 128 canvas, then a 3-layer Conv-BN-ReLU
stack (64 -> 64 -> 256). The two halves carry the reference's module names,
`radar_voxel_encoder` and `radar_bev_conv`, so the detector holds them as two
attributes."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pillars import PillarGrid, augment_pillar_points, pillar_bev_features
from .layers import BatchNorm, ConvModule, Linear


class PFNLayer(nn.Module):
    def __init__(self, cin: int = 13, cout: int = 64):
        super().__init__()
        self.linear = Linear(cin, cout, bias=False)
        # mmdet3d PFN norm cfg (eps 1e-3, momentum 0.01); the JAX package's
        # BatchNorm here computes the two-pass variance
        self.norm = BatchNorm(cout, eps=1e-3, momentum=0.01,
                              fast_variance=False)


class PillarFeatureNet(nn.Module):
    def __init__(self, grid: PillarGrid, feat_channels: int = 64,
                 max_pts_per_pillar: int = 10):
        super().__init__()
        self.grid = grid
        self.max_pts_per_pillar = max_pts_per_pillar
        self.pfn_layers = nn.ModuleList([PFNLayer(13, feat_channels)])

    def forward(self, points, mask):
        """points: [B, P, 7] (x, y, z, rcs, vx, vy, t); mask: [B, P] bool.
        Returns the pillar canvas [B, ny, nx, feat_channels] (float32). The
        z coordinate is zeroed first, as the reference's `extract_pts_feat`
        does."""
        points = points.float().clone()
        points[..., 2] = 0.0
        pfn = self.pfn_layers[0]
        aug = [augment_pillar_points(points[b], mask[b], self.grid,
                                     self.max_pts_per_pillar)
               for b in range(points.shape[0])]
        # one BatchNorm over the whole batch: in train mode its statistics
        # cover every sample's points (padding included), as in the JAX
        # package
        x = F.relu(pfn.norm(pfn.linear(torch.stack([a[0] for a in aug]))))
        return torch.stack([pillar_bev_features(x[b], ids, valid, self.grid)
                            for b, (_, ids, valid) in enumerate(aug)])


def radar_bev_conv(feat_channels: int = 64, out_channels: int = 256):
    return nn.Sequential(ConvModule(feat_channels, feat_channels, 3),
                         ConvModule(feat_channels, feat_channels, 3),
                         ConvModule(feat_channels, out_channels, 3))
