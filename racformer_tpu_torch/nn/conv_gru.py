"""ConvGRU temporal encoder for the radar BEV queue (port of
`racformer_tpu/nn/conv_gru.py`): downsample C -> 64 at stride 2, run a
ConvGRU over the first min(4, T) frames (later frames get the zero state),
upsample back (bilinear, align_corners=True), concatenate with the input and
fuse with a 3x3 conv. Parameter names follow the reference
(`downsample`, `upsample.1`, `temporal_fusion`, `convGRU.convGRUCell.*`)."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv2d, resize_bilinear_align_corners


class ConvGRUCell(nn.Module):
    def __init__(self, hidden: int = 64, kernel: int = 3):
        super().__init__()
        # the gates see input + matched hidden = 64 + 64 channels whatever
        # embed_dims is (the cell's input is the 64-channel downsample)
        self.matching_layer = Conv2d(hidden, hidden, 1)
        self.gates_conv = Conv2d(2 * hidden, 3 * hidden, kernel)

    def forward(self, x, h_prev):
        gates = self.gates_conv(torch.cat([x, self.matching_layer(h_prev)], dim=-1))
        z, r, cand = gates.chunk(3, dim=-1)
        z, r = torch.sigmoid(z), torch.sigmoid(r)
        cand = torch.tanh(cand + r * h_prev)
        return (1.0 - z) * h_prev + z * cand


class _ConvGRU(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.convGRUCell = ConvGRUCell(hidden)


class RadarBEVTemporalEncoder(nn.Module):
    def __init__(self, embed_dims: int = 256, hidden: int = 64,
                 max_steps: int = 4):
        super().__init__()
        self.hidden = hidden
        self.max_steps = max_steps
        self.downsample = Conv2d(embed_dims, hidden, 3, stride=2, padding=1)
        # index 0 is the reference's parameter-free nn.Upsample, applied in
        # forward as `resize_bilinear_align_corners`
        self.upsample = nn.Sequential(nn.Identity(), Conv2d(hidden, hidden, 3))
        self.temporal_fusion = Conv2d(embed_dims + hidden, embed_dims, 3)
        self.convGRU = _ConvGRU(hidden)

    def forward(self, bev: torch.Tensor) -> torch.Tensor:
        """bev: [B, T, H, W, C] -> temporally fused [B, T, H, W, C]."""
        B, T, H, W, C = bev.shape
        flat = bev.reshape(B * T, H, W, C)
        down = self.downsample(flat)
        h2, w2 = down.shape[1:3]
        down = down.reshape(B, T, h2, w2, self.hidden)
        h0 = down.new_zeros((B, h2, w2, self.hidden))
        h, hs = h0, []
        for t in range(T):
            if t >= min(self.max_steps, T):
                hs.append(h0)
                continue
            h = self.convGRU.convGRUCell(down[:, t], h)
            hs.append(h)
        hid = torch.stack(hs, dim=1).reshape(B * T, h2, w2, self.hidden)
        hid = self.upsample[1](resize_bilinear_align_corners(hid, (H, W)))
        fused = self.temporal_fusion(torch.cat([flat, hid], dim=-1))
        return fused.reshape(B, T, H, W, C)
