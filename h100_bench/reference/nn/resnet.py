"""ResNet-50 image backbone (port of `racformer_tpu/nn/resnet.py`):
torch-style bottlenecks with the stride on the 3x3 conv, BatchNorm frozen
(running statistics in train mode too), outputs C2..C5. Parameter names are mmdet's (`layer1.0.conv1`,
`layer1.0.downsample.0`, ...)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, FrozenBatchNorm


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm(planes * 4)) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet50(nn.Module):
    out_channels = (256, 512, 1024, 2048)  # C2..C5

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stage_blocks=(3, 4, 6, 3)):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin, planes = 64, 64
        for s, n in enumerate(stage_blocks):
            blocks = []
            for i in range(n):
                stride = 2 if (s > 0 and i == 0) else 1
                blocks.append(Bottleneck(cin, planes, stride, downsample=i == 0))
                cin = planes * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(stage_blocks)

    def forward(self, x):
        """x: [B, H, W, 3] -> (C2 [/4, 256], C3 [/8, 512], C4 [/16, 1024],
        C5 [/32, 2048]) in `dtype`."""
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
        x = x.permute(0, 2, 3, 1)
        outs = []
        for s in range(self.num_stages):
            x = getattr(self, f"layer{s + 1}")(x)
            outs.append(x)
        return tuple(outs)
