"""Radar-assisted DepthNet (port of `racformer_tpu/nn/depthnet.py`):
reduce conv, SE-modulated context and depth branches from a 9-dim camera
embedding, the depth branch concatenated with the radar depth one-hot grid
(D+1 channels) and a 32-channel RCS embedding, projected, then 3
BasicBlocks + ASPP + 1x1 to D depth logits. Parameter names follow the
reference (`reduce_conv.0`, `depth_conv.3.aspp2.atrous_conv`, ...)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d, Dropout, Mlp, SELayer


class BasicBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = Conv2d(ch, ch, 3, bias=False)
        self.bn1 = BatchNorm(ch)
        self.conv2 = Conv2d(ch, ch, 3, bias=False)
        self.bn2 = BatchNorm(ch)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class _ASPPModule(nn.Module):
    def __init__(self, ch: int, kernel: int, dilation: int):
        super().__init__()
        self.atrous_conv = Conv2d(ch, ch, kernel, dilation=dilation, bias=False)
        self.bn = BatchNorm(ch)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class _GlobalPool(nn.Module):
    """Keys `global_avg_pool.1` (conv) and `.2` (bn), as the reference's
    Sequential(AdaptiveAvgPool2d, Conv2d, BatchNorm2d, ReLU)."""

    def __init__(self, ch: int):
        super().__init__()
        self.add_module("1", Conv2d(ch, ch, 1, bias=False))
        self.add_module("2", BatchNorm(ch))

    def forward(self, x):
        g = x.mean(dim=(1, 2), keepdim=True)
        return F.relu(getattr(self, "2")(getattr(self, "1")(g)))


class ASPP(nn.Module):
    def __init__(self, ch: int = 256):
        super().__init__()
        self.aspp1 = _ASPPModule(ch, 1, 1)
        self.aspp2 = _ASPPModule(ch, 3, 6)
        self.aspp3 = _ASPPModule(ch, 3, 12)
        self.aspp4 = _ASPPModule(ch, 3, 18)
        self.global_avg_pool = _GlobalPool(ch)
        self.conv1 = Conv2d(ch * 5, ch, 1, bias=False)
        self.bn1 = BatchNorm(ch)
        self.dropout = Dropout(0.5)

    def forward(self, x):
        a = [self.aspp1(x), self.aspp2(x), self.aspp3(x), self.aspp4(x)]
        gap = self.global_avg_pool(x).expand_as(a[3])
        out = torch.cat(a + [gap], dim=-1)
        return self.dropout(F.relu(self.bn1(self.conv1(out))))


class DepthNet(nn.Module):
    def __init__(self, in_channels: int = 256, mid_channels: int = 256,
                 context_channels: int = 256, depth_channels: int = 96):
        super().__init__()
        mid = mid_channels
        self.reduce_conv = nn.Sequential(
            Conv2d(in_channels, mid, 3, bias=True), BatchNorm(mid), nn.ReLU())
        self.bn = BatchNorm(9)
        self.context_mlp = Mlp(9, mid, mid)
        self.context_se = SELayer(mid)
        self.context_conv = Conv2d(mid, context_channels, 1)
        self.depth_mlp = Mlp(9, mid, mid)
        self.depth_se = SELayer(mid)
        self.dep_proj = Conv2d(mid + depth_channels + 1 + 32, mid, 1)
        self.depth_conv = nn.Sequential(
            BasicBlock(mid), BasicBlock(mid), BasicBlock(mid), ASPP(mid),
            Conv2d(mid, depth_channels, 1))

    def forward(self, x, radar_depth_grids, rcs_embedding, mlp_input):
        """x: [BN, H, W, C]; radar_depth_grids: [BN, H, W, D+1];
        rcs_embedding: [BN, H, W, 32]; mlp_input: [BN, 9].
        Returns [BN, H, W, D + context_channels] (depth logits | context)."""
        mlp_input = self.bn(mlp_input)
        x = self.reduce_conv(x)
        context = self.context_se(x, self.context_mlp(mlp_input))
        context = self.context_conv(context)
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        depth = torch.cat([depth, radar_depth_grids.to(depth.dtype),
                           rcs_embedding.to(depth.dtype)], dim=-1)
        depth = self.depth_conv(self.dep_proj(depth))
        return torch.cat([depth, context], dim=-1)
