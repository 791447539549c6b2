"""ConvGRU temporal encoder for the radar BEV queue (port of
`racformer_tpu/nn/conv_gru.py`): downsample C -> 64 at stride 2, run a
ConvGRU over the first min(4, T) frames (later frames get the zero state;
the states of steps t > 1 take no gradient, as in the reference), upsample
back (bilinear, align_corners=True), concatenate with the input and
fuse with a 3x3 conv, all in `dtype` (the head's). Parameter names follow
the reference
(`downsample`, `upsample.1`, `temporal_fusion`, `convGRU.convGRUCell.*`)."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv2d, resize_bilinear_align_corners


def _sigmoid(x):
    """The logistic as the JAX package's program computes it on the CPU
    below float32 (XLA's expansion 1 / (1 + exp(-x)), each op rounded)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


class ConvGRUCell(nn.Module):
    def __init__(self, hidden: int = 64, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # the gates see input + matched hidden = 64 + 64 channels whatever
        # embed_dims is (the cell's input is the 64-channel downsample)
        self.matching_layer = Conv2d(hidden, hidden, 1, dtype=dtype)
        self.gates_conv = Conv2d(2 * hidden, 3 * hidden, kernel, dtype=dtype)

    def forward(self, x, h_prev):
        gates = self.gates_conv(torch.cat([x, self.matching_layer(h_prev)], dim=-1))
        z, r, cand = gates.chunk(3, dim=-1)
        z, r = _sigmoid(z), _sigmoid(r)
        cand = torch.tanh(cand + r * h_prev)
        return (1.0 - z) * h_prev + z * cand


class _ConvGRU(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.convGRUCell = ConvGRUCell(hidden, dtype=dtype)


class RadarBEVTemporalEncoder(nn.Module):
    def __init__(self, embed_dims: int = 256, hidden: int = 64,
                 max_steps: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.max_steps = max_steps
        self.downsample = Conv2d(embed_dims, hidden, 3, stride=2, padding=1,
                                 dtype=dtype)
        # index 0 is the reference's parameter-free nn.Upsample, applied in
        # forward as `resize_bilinear_align_corners`
        self.upsample = nn.Sequential(
            nn.Identity(), Conv2d(hidden, hidden, 3, dtype=dtype))
        self.temporal_fusion = Conv2d(embed_dims + hidden, embed_dims, 3,
                                      dtype=dtype)
        self.convGRU = _ConvGRU(hidden, dtype)

    def forward(self, bev: torch.Tensor) -> torch.Tensor:
        """bev: [B, T, H, W, C] -> temporally fused [B, T, H, W, C]."""
        B, T, H, W, C = bev.shape
        flat = bev.to(self.dtype).reshape(B * T, H, W, C)
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
            if t > 1:
                h = h.detach()
            hs.append(h)
        hid = torch.stack(hs, dim=1).reshape(B * T, h2, w2, self.hidden)
        hid = self.upsample[1](resize_bilinear_align_corners(hid, (H, W)))
        fused = self.temporal_fusion(torch.cat([flat, hid], dim=-1))
        return fused.reshape(B, T, H, W, C)
