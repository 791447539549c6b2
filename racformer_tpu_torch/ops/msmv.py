"""Multi-scale multi-view image sampling over the level-concatenated map
(port of `racformer_tpu/ops/msmv.py`: `msmv_sample_fold` and the per-level
path `msmv_sample_xyv`).

For every (slab, query, point), bilinearly sample every pyramid level of the
selected camera with the `align_corners=True` mapping `x_pix = x * (W - 1)`,
zero outside the image, and sum the levels with per-(point, level) weights.
The levels of one camera are row-concatenated in one sampler-ready map
(built per frame by `RaCFormer._trunk`), so one kernel launch samples every
level: points are level-interleaved (level fastest). The eval path
(`msmv_sample_fold`, K1) sums each `fold = L` consecutive points in the
kernel; the training path (`msmv_sample_levels`, K2 forward, K3 / K4
backward) returns every level's sample and weights and sums the levels in
PyTorch, as the JAX per-level path does in XLA.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .bilinear import corner_coords, patch_sample, sampler_ready
from .gather_kernel import patch_sample_fold


def level_concat(levels):
    """L maps [..., h_l, w_l, c] -> the level-concatenated sampler-ready map
    [..., rcat, Wmax, 2c]: each level made sampler-ready, zero-padded on the
    right to the widest and stacked along the rows (level l from row
    roffs[l] of `nn.img_sampling.concat_geometry`)."""
    ready = [sampler_ready(f) for f in levels]
    wmax = max(f.shape[-2] for f in ready)
    return torch.cat([F.pad(f, (0, 0, 0, wmax - f.shape[-2])) for f in ready],
                     dim=-3)


def level_points(x_norm, y_norm, view, true_hws, roffs, rcat, wdtype):
    """Per-point (row, x0p, wx, wy), each [S, Q*P*L] with the level fastest,
    of the level-concatenated map; wx / wy rounded to `wdtype`."""
    L = len(true_hws)
    S, Q, P = x_norm.shape
    rows, x0s, wxs, wys = [], [], [], []
    for l, (H, W) in enumerate(true_hws):
        x0p, y0p, wx, wy = corner_coords(x_norm * (W - 1), y_norm * (H - 1),
                                         H, W, wdtype)
        rows.append(view.to(torch.int32) * rcat + roffs[l] + y0p)
        x0s.append(x0p)
        wxs.append(wx)
        wys.append(wy)

    def inter(parts):  # L x [S, Q, P] -> [S, Q*P*L]
        return torch.stack(parts, dim=-1).reshape(S, Q * P * L)

    return inter(rows), inter(x0s), inter(wxs), inter(wys)


def image_fold_inputs(x_norm, y_norm, view, weights, true_hws, roffs, rcat):
    """Per-point fold-gather inputs (row, x0p, wx, wy, wl), each
    [S, Q*P*L] with the level fastest, for `msmv_sample_fold`'s arguments
    (f32 lerp weights, as the JAX fold path has them)."""
    S, Q, P = x_norm.shape
    return (*level_points(x_norm, y_norm, view, true_hws, roffs, rcat,
                          torch.float32),
            weights.float().contiguous().reshape(S, -1))


def msmv_sample_fold(
    feat_cat: torch.Tensor,
    x_norm: torch.Tensor,
    y_norm: torch.Tensor,
    view: torch.Tensor,
    weights: torch.Tensor,
    true_hws: Sequence[tuple],
    roffs: Sequence[int],
    rcat: int,
) -> torch.Tensor:
    """feat_cat: [S, N * rcat, Wmax, 2C] (or [S, N, rcat, Wmax, 2C]); level l
    of camera n starts at row n * rcat + roffs[l]. x_norm / y_norm: [S, Q, P]
    normalized coordinates; view: int [S, Q, P]; weights: [S, Q, P, L]
    per-level weights; true_hws: the L levels' real (H, W).

    Returns [S, Q, P, C] in the map dtype."""
    if feat_cat.dim() == 5:
        feat_cat = feat_cat.reshape(feat_cat.shape[0], -1, *feat_cat.shape[3:])
    S, Q, P = x_norm.shape
    out = patch_sample_fold(
        feat_cat, *image_fold_inputs(x_norm, y_norm, view, weights, true_hws,
                                     roffs, rcat), len(true_hws))
    return out.reshape(S, Q, P, out.shape[-1])


def msmv_sample_levels(
    feat_cat: torch.Tensor,
    x_norm: torch.Tensor,
    y_norm: torch.Tensor,
    view: torch.Tensor,
    weights: torch.Tensor,
    true_hws: Sequence[tuple],
    roffs: Sequence[int],
    rcat: int,
) -> torch.Tensor:
    """The training path of `msmv_sample_fold` (same arguments and result):
    one `patch_sample_op` over every level's points, then the per-level weights
    and the level sum in the map dtype, as the JAX per-level path
    (`msmv_sample_xyv` with the Pallas forward) computes them. wx / wy are
    rounded to the map dtype, as there. Differentiable in the map, the
    coordinates and the weights."""
    if feat_cat.dim() == 5:
        feat_cat = feat_cat.reshape(feat_cat.shape[0], -1, *feat_cat.shape[3:])
    S, Q, P = x_norm.shape
    L = len(true_hws)
    out = patch_sample(feat_cat, *level_points(
        x_norm, y_norm, view, true_hws, roffs, rcat, feat_cat.dtype))
    out = out.reshape(S, Q, P, L, out.shape[-1])
    return (out * weights[..., None].to(out.dtype)).sum(3)
