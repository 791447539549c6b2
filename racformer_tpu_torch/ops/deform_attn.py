"""Single-level multi-head deformable attention sampling over a BEV map
(port of the fold path of `racformer_tpu/ops/deform_attn.py`).

Semantics of mmcv's `ms_deform_attn` with one level: sampling grid
`loc * 2 - 1` fed to `grid_sample(align_corners=False, padding_mode='zeros')`,
i.e. pixel coordinates `x_pix = x * W - 0.5`, output the attention-weighted
sum over points per head. The fold gather sums `fold_points` consecutive
points in the kernel; the remaining `P // fold_points` partial sums are
added here in f32.
"""

from __future__ import annotations

import torch

from .bilinear import PAD
from .gather_kernel import patch_sample_fold


def bev_fold_inputs(x_norm, y_norm, weights, true_hw, rows_per_head):
    """Per-point fold-gather inputs (row, x0p, wx, wy, wl), each
    [S, Q*M*P], for `deform_attn_single_level`'s arguments; head m's map
    starts at row m * rows_per_head."""
    S, Q, M, P = x_norm.shape
    H, W = true_hw
    x_pix = x_norm * W - 0.5
    y_pix = y_norm * H - 0.5
    x0 = torch.floor(x_pix)
    y0 = torch.floor(y_pix)
    wx = (x_pix - x0).float()
    wy = (y_pix - y0).float()
    x0p = x0.clamp(-PAD, W).to(torch.int32) + PAD
    y0p = y0.clamp(-PAD, H).to(torch.int32) + PAD
    head = torch.arange(M, dtype=torch.int32, device=x_norm.device)
    row = head[None, None, :, None] * rows_per_head + y0p

    def flat(t):  # [S, Q, M, P] -> contiguous [S, Q*M*P]
        return t.reshape(S, -1).contiguous()

    return flat(row), flat(x0p), flat(wx), flat(wy), flat(weights.float())


def deform_attn_single_level(
    value: torch.Tensor,
    x_norm: torch.Tensor,
    y_norm: torch.Tensor,
    weights: torch.Tensor,
    true_hw: tuple,
    fold_points: int,
) -> torch.Tensor:
    """value: [S, M, H + 2*PAD - 1, W + 2*PAD, 2c] head-major sampler-ready
    map (`nn.bev_sampling.BEVSampling.project_value`); x_norm / y_norm:
    [S, Q, M, P] in [0, 1]; weights: [S, Q, M, P]; true_hw: the map's real
    (H, W).

    Returns [S, Q, M * c] in the map dtype."""
    S, M, R0, Wp, c2 = value.shape
    Q, P = x_norm.shape[1], x_norm.shape[3]
    if P % fold_points:
        raise ValueError(f"P={P} is not a multiple of fold={fold_points}")
    out = patch_sample_fold(
        value.reshape(S, M * R0, Wp, c2),
        *bev_fold_inputs(x_norm, y_norm, weights, true_hw, R0), fold_points)
    out = out.reshape(S, Q, M, P // fold_points, c2 // 2)
    return out.float().sum(3).to(out.dtype).reshape(S, Q, M * c2 // 2)
