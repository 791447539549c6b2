"""Sampler-ready feature maps (port of `racformer_tpu/ops/bilinear.py`
`PAD`, `pad_for_sampling` and `fuse_rows`).

A sampler-ready map is zero-bordered by `PAD` on both spatial axes and
y-fused: row h of the fused map holds rows h and h+1 of the bordered map in
its two channel halves, so every 2x2 bilinear patch is two adjacent columns
of one fused row. The fold gather (`ops.gather_kernel`) reads columns
`x0p` and `x0p + 1 <= W + PAD + 1`, so the stored width `W + 2 * PAD` is
enough: the JAX package's extra right padding to an 8-aligned width exists
only for the TPU kernel's aligned 16-wide windows and is not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PAD = 2  # zero border; sampling coordinates are clamped to [-PAD, W]


def pad_for_sampling(feat: torch.Tensor) -> torch.Tensor:
    """Zero-pad the two spatial axes of [..., H, W, C] by `PAD`."""
    return F.pad(feat, (0, 0, PAD, PAD, PAD, PAD))


def fuse_rows(padded: torch.Tensor) -> torch.Tensor:
    """fused[..., h, w, :] = concat(p[..., h, w, :], p[..., h+1, w, :]):
    [..., Hp, Wp, C] -> [..., Hp - 1, Wp, 2C]."""
    return torch.cat([padded[..., :-1, :, :], padded[..., 1:, :, :]], dim=-1)


def sampler_ready(feat: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> zero-bordered y-fused [..., H + 2*PAD - 1,
    W + 2*PAD, 2C]."""
    return fuse_rows(pad_for_sampling(feat))
