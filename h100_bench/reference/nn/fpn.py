"""Feature pyramid necks (port of `racformer_tpu/nn/fpn.py`).

`FPN`: mmdet's FPN as the reference configures it (4 levels in, 4 out,
1x1 laterals, nearest top-down upsampling, 3x3 outputs, no norms).
`CustomFPN`: the reference's single-output variant (in_channels
[1024, 2048], out_ids [0]): the same top-down path, one 3x3 output conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import ConvModule


def upsample_nearest(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Integer-factor nearest upsampling of [B, H, W, C], cropped to
    `target_hw`."""
    th, tw = target_hw
    x = x.repeat_interleave(th // x.shape[1], dim=1)
    x = x.repeat_interleave(tw // x.shape[2], dim=2)
    return x[:, :th, :tw]


def _top_down(laterals):
    for i in range(len(laterals) - 1, 0, -1):
        laterals[i - 1] = laterals[i - 1] + upsample_nearest(
            laterals[i], laterals[i - 1].shape[1:3])
    return laterals


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1, bias=True, norm=False, act=False)
             for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, bias=True, norm=False,
                        act=False) for _ in in_channels])

    def forward(self, inputs):
        lat = _top_down([m(x) for m, x in zip(self.lateral_convs, inputs)])
        return tuple(m(x) for m, x in zip(self.fpn_convs, lat))


class CustomFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1, bias=True, norm=False, act=False)
             for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, bias=True, norm=False,
                        act=False)])

    def forward(self, inputs):
        lat = _top_down([m(x) for m, x in zip(self.lateral_convs, inputs)])
        return self.fpn_convs[0](lat[0])
