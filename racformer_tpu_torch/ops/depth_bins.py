"""SID (spacing-increasing discretization) depth bins (port of
`racformer_tpu/ops/depth_bins.py`).

With depth config (d_min, d_max, D):
  bin_size = 2 * (d_max - d_min) / (D * (1 + D))
  value(i) = (i + 0.5)^2 * bin_size / 2 - bin_size / 8 + d_min
  index(v) = -0.5 + 0.5 * sqrt(1 + 8 * (v - d_min) / bin_size)   (truncated)
"""

from __future__ import annotations

import torch


def sid_bin_size(d_min: float, d_max: float, num_bins: int) -> float:
    return 2.0 * (d_max - d_min) / (num_bins * (1.0 + num_bins))


def sid_bin_values(d_min: float, d_max: float, num_bins: int) -> torch.Tensor:
    """Bin-center depth values, shape [num_bins]."""
    bin_size = sid_bin_size(d_min, d_max, num_bins)
    idx = torch.arange(num_bins, dtype=torch.float32)
    return (idx + 0.5) ** 2 * bin_size / 2.0 - bin_size / 8.0 + d_min


def depth_to_sid_index(depth: torch.Tensor, d_min: float, d_max: float,
                       num_bins: int) -> torch.Tensor:
    """Continuous depth -> int64 SID bin index; out-of-range or non-finite
    depths map to `num_bins` (the background index)."""
    bin_size = sid_bin_size(d_min, d_max, num_bins)
    arg = 1.0 + 8.0 * (depth - d_min) / bin_size
    idx = -0.5 + 0.5 * torch.sqrt(arg.clamp(min=0.0))
    invalid = (idx < 0) | (idx > num_bins) | ~torch.isfinite(idx) | (arg < 0)
    idx = torch.where(invalid, torch.full_like(idx, float(num_bins)), idx)
    return idx.long()
