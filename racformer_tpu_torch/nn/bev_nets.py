"""BEV-space auxiliary networks (port of `racformer_tpu/nn/bev_nets.py`).

`BEVResNet` is the reference's `CustomResNet`: stages of BasicBlocks over a
BEV map, each stage's first block strided, with a bare 3x3 strided conv
(bias, no norm) on its identity. `FPNLSS` is `FPN_LSS`: the deepest chosen
map upsampled (bilinear, align_corners=True) onto the shallowest, two 3x3
conv-BN-ReLU, then an extra upsample, a conv-BN-ReLU and a 1x1 projection
with bias. Channel-last, train-mode BatchNorm with batch statistics (the
port's `BatchNorm`). No model of either package selects them.

A strided 3x3 conv pads as XLA's "SAME" does, which the JAX package uses
there: the odd pixel of the padding goes to the bottom and right (0 and 1
on an even side at stride 2), not 1 on each side as the reference's conv.

State-dict names are the reference's: `layers.0.0.conv1.weight`,
`layers.0.0.bn1.running_mean`, `layers.0.0.downsample.weight`;
`conv.0.weight`, `conv.1.weight`, `up2.1.weight`, `up2.4.bias`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .depthnet import BasicBlock
from .layers import BatchNorm, Conv2d, resize_bilinear_align_corners


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad [B, H, W, C] as XLA's "SAME" padding for `kernel` at
    `stride` (the extra pixel at the bottom and right)."""
    pads = []
    for n in (x.shape[2], x.shape[1]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0, *pads))


class StridedBasicBlock(nn.Module):
    """A BasicBlock whose first conv is strided (SAME padding) and whose
    identity is a bare 3x3 strided conv with bias (`downsample`)."""

    def __init__(self, cin: int, ch: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(cin, ch, 3, stride=stride, padding=0, bias=False)
        self.bn1 = BatchNorm(ch)
        self.conv2 = Conv2d(ch, ch, 3, bias=False)
        self.bn2 = BatchNorm(ch)
        self.downsample = Conv2d(cin, ch, 3, stride=stride, padding=1)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(same_pad(x, 3, self.stride))))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.downsample(x))


class BEVResNet(nn.Module):
    def __init__(self, in_channels: int, num_layer: Sequence[int] = (2, 2, 2),
                 num_channels: Optional[Sequence[int]] = None,
                 stride: Sequence[int] = (2, 2, 2),
                 output_ids: Optional[Sequence[int]] = None):
        """`num_channels` defaults to in_channels * 2^(i+1) for stage i;
        `output_ids` (default: every stage) picks the returned stages."""
        super().__init__()
        chans = num_channels or [in_channels * 2 ** (i + 1)
                                 for i in range(len(num_layer))]
        self.output_ids = tuple(range(len(num_layer)) if output_ids is None
                                else output_ids)
        self.layers = nn.ModuleList()
        cin = in_channels
        for n, ch, st in zip(num_layer, chans, stride):
            self.layers.append(nn.Sequential(
                StridedBasicBlock(cin, ch, st),
                *[BasicBlock(ch) for _ in range(n - 1)]))
            cin = ch

    def forward(self, x):
        """x: [B, H, W, C] -> the chosen stages' maps."""
        feats = []
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i in self.output_ids:
                feats.append(x)
        return feats


class FPNLSS(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 4, input_feature_index=(0, 2),
                 extra_upsample: int = 2):
        """in_channels: the two chosen maps' channels together."""
        super().__init__()
        self.scale_factor = scale_factor
        self.input_feature_index = tuple(input_feature_index)
        self.extra_upsample = extra_upsample
        cf = 2 if extra_upsample else 1
        self.conv = nn.Sequential(
            Conv2d(in_channels, out_channels * cf, 3, bias=False),
            BatchNorm(out_channels * cf), nn.ReLU(),
            Conv2d(out_channels * cf, out_channels * cf, 3, bias=False),
            BatchNorm(out_channels * cf), nn.ReLU())
        if extra_upsample:
            # index 0 is the reference's parameter-free nn.Upsample
            self.up2 = nn.Sequential(
                nn.Identity(),
                Conv2d(out_channels * cf, out_channels, 3, bias=False),
                BatchNorm(out_channels), nn.ReLU(),
                Conv2d(out_channels, out_channels, 1))

    def forward(self, feats):
        """feats: the BEV maps [B, H_i, W_i, C_i] -> [B, H, W, out]."""
        x2 = feats[self.input_feature_index[0]]
        x1 = feats[self.input_feature_index[1]]
        h, w = x1.shape[1:3]
        x1 = resize_bilinear_align_corners(
            x1, (h * self.scale_factor, w * self.scale_factor))
        x = self.conv(torch.cat([x2, x1], dim=-1))
        if self.extra_upsample:
            h, w = x.shape[1:3]
            x = resize_bilinear_align_corners(
                x, (h * self.extra_upsample, w * self.extra_upsample))
            x = self.up2[1:](x)
        return x
