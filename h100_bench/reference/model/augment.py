"""Training augmentation on the device (port of
`racformer_tpu/model/augment.py`): photometric distortion (brightness,
contrast, saturation and hue jitter) and GridMask occlusion.

The random draws are made by `photometric_draws` / `grid_mask_draws` from an
explicit generator and passed to the transforms, so a caller (or a test)
can hold them fixed; the JAX package draws the same quantities from a PRNG
key inside its train step.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def photometric_draws(batch: int,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Per-sample draws [B] of `photometric_distortion`: whether each of
    the four jitters applies (probability 0.5) and its amount (brightness
    delta in [-32, 32), contrast and saturation factors in [0.5, 1.5), hue
    shift in [-18, 18) degrees of the JAX package's chroma rotation)."""
    def coin():
        return torch.rand(batch, generator=generator) < 0.5

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator)

    return {
        "do_b": coin(), "delta": uniform(-32.0, 32.0),
        "do_c": coin(), "alpha": uniform(0.5, 1.5),
        "do_s": coin(), "sat": uniform(0.5, 1.5),
        "do_h": coin(), "ang": uniform(-18.0, 18.0),
    }


def photometric_distortion(imgs: torch.Tensor, draws) -> torch.Tensor:
    """imgs: [B, ..., H, W, 3] raw 0-255 BGR; draws from `photometric_draws`.
    Returns the jittered images in f32, clipped to [0, 255]."""
    shape = (imgs.shape[0],) + (1,) * (imgs.dim() - 1)
    d = {k: v.reshape(shape) for k, v in draws.items()}
    x = imgs.float()
    x = torch.where(d["do_b"], x + d["delta"], x)
    x = torch.where(d["do_c"], x * d["alpha"], x)
    luma = 0.114 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.299 * x[..., 2:3]
    x = torch.where(d["do_s"], luma + (x - luma) * d["sat"], x)
    # hue: rotate the two chroma axes (the JAX package's approximation of
    # an HSV hue shift)
    ang = d["ang"] * (math.pi / 90.0)
    cb = x[..., 0:1] - luma
    cr = x[..., 2:3] - luma
    hue_x = torch.cat([luma + cb * torch.cos(ang) - cr * torch.sin(ang),
                       x[..., 1:2],
                       luma + cb * torch.sin(ang) + cr * torch.cos(ang)], dim=-1)
    x = torch.where(d["do_h"], hue_x, x)
    return x.clamp(0.0, 255.0)


def grid_mask_draws(height: int, generator: torch.Generator) -> Dict[str, int]:
    """The draws of `grid_mask` (one for the whole batch): whether it
    applies (probability 0.7), the period d in [2, H) and the two offsets
    in [0, d)."""
    def randint(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=generator))

    apply = bool(torch.rand(1, generator=generator) < 0.7)
    d = randint(2, height)
    return {"apply": apply, "d": d, "st_h": randint(0, d),
            "st_w": randint(0, d)}


def grid_mask(imgs: torch.Tensor, draws) -> torch.Tensor:
    """GridMask: zero a regular grid of stripes of period d (rows and
    columns where ((coord + offset) mod d) < l, l = d / 2 rounded and
    clipped to [1, d - 1]) in every image of the batch."""
    if not draws["apply"]:
        return imgs
    H, W = imgs.shape[-3], imgs.shape[-2]
    d, st_h, st_w = draws["d"], draws["st_h"], draws["st_w"]
    l = min(max(int(d * 0.5 + 0.5), 1), d - 1)
    ys = torch.arange(H, device=imgs.device)
    xs = torch.arange(W, device=imgs.device)
    off_h = (ys + (d - (st_h + H // 4) % d)) % d
    off_w = (xs + (d - (st_w + W // 4) % d)) % d
    keep = ~((off_h < l)[:, None] | (off_w < l)[None, :])
    return imgs * keep.to(imgs.dtype)[..., None]
