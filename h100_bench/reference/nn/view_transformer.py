"""LSS view transformer with radar-assisted depth (port of
`racformer_tpu/nn/view_transformer.py`).

The radar depth map is min-pooled to the feature stride and SID-quantized to
a (D+1) one-hot grid; the RCS map is max-pooled and 64-bin one-hot embedded
through a 1x1 conv (64 -> 32). The frustum is a fixed template (a buffer, as
in the reference checkpoint); the splat is `ops.bev_pool.bev_pool`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bev_pool import bev_pool, frustum_grid, make_frustum
from ..ops.depth_bins import depth_to_sid_index, sid_bin_values
from .depthnet import DepthNet
from .layers import Conv1x1Linear


def downsample_min_depth(depth: torch.Tensor, ds: int) -> torch.Tensor:
    """[BN, H, W] -> [BN, H/ds, W/ds] block min, zeros treated as missing."""
    BN, H, W = depth.shape
    d = torch.where(depth == 0.0, torch.full_like(depth, 1e5), depth)
    return d.reshape(BN, H // ds, ds, W // ds, ds).amin(dim=(2, 4))


def downsample_max_rcs(rcs: torch.Tensor, ds: int) -> torch.Tensor:
    """[BN, H, W] -> block max, values < -64 treated as missing."""
    BN, H, W = rcs.shape
    r = torch.where(rcs < -64.0, torch.full_like(rcs, -1e5), rcs)
    return r.reshape(BN, H // ds, ds, W // ds, ds).amax(dim=(2, 4))


def rcs_one_hot(rcs: torch.Tensor, lo: float = -64.0, hi: float = 64.0,
                bins: int = 64) -> torch.Tensor:
    """64-bin one-hot RCS grid (float32); out-of-range -> all zero."""
    bin_size = (hi - lo) / bins
    idx = (rcs - (lo - bin_size)) / bin_size
    idx = torch.where((idx < bins + 1) & (idx >= -1), idx,
                      torch.full_like(idx, -1.0))
    idx = idx.to(torch.int64)  # truncation toward zero, like torch .long()
    # one_hot of -1 is all-zero in the JAX reference; shift by one and drop
    # the first two classes to get the same (bins 1..64 of 0..64)
    oh = F.one_hot(idx + 1, bins + 2)[..., 2:]
    return oh.to(torch.float32)


class LSSViewTransformer(nn.Module):
    """One frame: image features + radar maps -> BEV feature map."""

    def __init__(self, input_size=(256, 704), downsample: int = 16,
                 depth_bins: int = 96, depth_range=(1.0, 65.0),
                 in_channels: int = 256, out_channels: int = 256,
                 grid_lower=(-51.2, -51.2, -5.0), grid_interval=(0.8, 0.8, 8.0),
                 grid_size=(128, 128, 1), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_size = tuple(input_size)
        self.downsample = downsample
        self.depth_bins = depth_bins
        self.depth_range = tuple(depth_range)
        self.out_channels = out_channels
        self.grid_lower = tuple(grid_lower)
        self.grid_interval = tuple(grid_interval)
        self.grid_size = tuple(grid_size)
        self.dtype = dtype
        self.depth_net = DepthNet(in_channels, 256, out_channels, depth_bins)
        self.rcs_embedding = Conv1x1Linear(64, 32)
        self.register_buffer("frustum", make_frustum(
            self.input_size, downsample,
            sid_bin_values(*self.depth_range, depth_bins)))

    def forward(self, feats, radar_depth, radar_rcs, img2lidar, mlp_input):
        """feats: [B, N, Hf, Wf, C]; radar_depth / radar_rcs:
        [B, N, H_img, W_img]; img2lidar: [B, N, 4, 4]; mlp_input: [B, N, 9].

        Returns (bev [B, ny, nx, out_channels] f32,
                 depth_logits [B, N, Hf, Wf, D])."""
        B, N, Hf, Wf, C = feats.shape
        ds, D = self.downsample, self.depth_bins
        d_lo, d_hi = self.depth_range
        rd = downsample_min_depth(radar_depth.reshape(B * N, *radar_depth.shape[2:]), ds)
        rad_grids = F.one_hot(depth_to_sid_index(rd, d_lo, d_hi, D), D + 1)
        rr = downsample_max_rcs(radar_rcs.reshape(B * N, *radar_rcs.shape[2:]), ds)
        rcs_emb = self.rcs_embedding(rcs_one_hot(rr).to(self.dtype))

        x = self.depth_net(feats.reshape(B * N, Hf, Wf, C).to(self.dtype),
                           rad_grids, rcs_emb,
                           mlp_input.reshape(B * N, 9).to(self.dtype))
        depth_logits = x[..., :D]
        context = x[..., D:].float().reshape(B, N, Hf, Wf, self.out_channels)
        depth = torch.softmax(depth_logits.float(), dim=-1)
        depth = depth.reshape(B, N, Hf, Wf, D).permute(0, 1, 4, 2, 3)

        bev = []
        for b in range(B):
            rank, valid = frustum_grid(self.frustum, img2lidar[b].float(),
                                       self.grid_lower, self.grid_interval,
                                       self.grid_size)
            bev.append(bev_pool(depth[b], context[b], rank, valid,
                                self.grid_size))
        return torch.stack(bev), depth_logits.reshape(B, N, Hf, Wf, D)
