"""Single-level multi-head deformable attention sampling over a BEV map
(port of `racformer_tpu/ops/deform_attn.py`: the fold path and the per-point
path the training step takes).

Semantics of mmcv's `ms_deform_attn` with one level: sampling grid
`loc * 2 - 1` fed to `grid_sample(align_corners=False, padding_mode='zeros')`,
i.e. pixel coordinates `x_pix = x * W - 0.5`, output the attention-weighted
sum over points per head. The eval path's fold gather (K1) sums
`fold_points` consecutive points in the kernel and the remaining
`P // fold_points` partial sums are added here in f32; the training path
(`fold_points=0`) samples every point with `patch_sample_op` (K2 forward, K3 / K4
backward) and sums the weighted points here, in the map dtype.
"""

from __future__ import annotations

import torch

from .bilinear import corner_coords, patch_sample
from .gather_kernel import patch_sample_fold


def bev_points(x_norm, y_norm, true_hw, rows_per_head, wdtype):
    """Per-point (row, x0p, wx, wy), each [S, Q*M*P], of the head-major map
    (head m's map starts at row m * rows_per_head); wx / wy rounded to
    `wdtype`."""
    S, Q, M, P = x_norm.shape
    H, W = true_hw
    x0p, y0p, wx, wy = corner_coords(x_norm * W - 0.5, y_norm * H - 0.5, H, W,
                                     wdtype)
    head = torch.arange(M, dtype=torch.int32, device=x_norm.device)
    row = head[None, None, :, None] * rows_per_head + y0p

    def flat(t):  # [S, Q, M, P] -> contiguous [S, Q*M*P]
        return t.reshape(S, -1).contiguous()

    return flat(row), flat(x0p), flat(wx), flat(wy)


def bev_fold_inputs(x_norm, y_norm, weights, true_hw, rows_per_head):
    """Per-point fold-gather inputs (row, x0p, wx, wy, wl), each
    [S, Q*M*P], for `deform_attn_single_level`'s arguments (f32 lerp
    weights, as the JAX fold path has them)."""
    S = x_norm.shape[0]
    return (*bev_points(x_norm, y_norm, true_hw, rows_per_head, torch.float32),
            weights.float().reshape(S, -1).contiguous())


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
    (H, W); fold_points: points summed in the kernel (eval), or 0 for the
    differentiable per-point path of training.

    Returns [S, Q, M * c] in the map dtype."""
    S, M, R0, Wp, c2 = value.shape
    Q, P = x_norm.shape[1], x_norm.shape[3]
    if not fold_points:
        out = patch_sample(value.reshape(S, M * R0, Wp, c2), *bev_points(
            x_norm, y_norm, true_hw, R0, value.dtype), site="bev")
        out = out.reshape(S, Q, M, P, c2 // 2)
        out = (out * weights[..., None].to(out.dtype)).sum(3)
        return out.reshape(S, Q, M * c2 // 2)
    if P % fold_points:
        raise ValueError(f"P={P} is not a multiple of fold={fold_points}")
    out = patch_sample_fold(
        value.reshape(S, M * R0, Wp, c2),
        *bev_fold_inputs(x_norm, y_norm, weights, true_hw, R0), fold_points)
    out = out.reshape(S, Q, M, P // fold_points, c2 // 2)
    return out.float().sum(3).to(out.dtype).reshape(S, Q, M * c2 // 2)
