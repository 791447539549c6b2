"""Multi-scale multi-view image sampling over the level-concatenated map
(port of `racformer_tpu/ops/msmv.py::msmv_sample_fold`).

For every (slab, query, point), bilinearly sample every pyramid level of the
selected camera with the `align_corners=True` mapping `x_pix = x * (W - 1)`,
zero outside the image, and sum the levels with per-(point, level) weights.
The levels of one camera are row-concatenated in one sampler-ready map
(built per frame by `RaCFormer._trunk`), so one fold-gather launch does all
of it: points are level-interleaved (level fastest) and each output sums
`fold = L` consecutive points.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .bilinear import PAD
from .gather_kernel import patch_sample_fold


def image_fold_inputs(x_norm, y_norm, view, weights, true_hws, roffs, rcat):
    """Per-point fold-gather inputs (row, x0p, wx, wy, wl), each
    [S, Q*P*L] with the level fastest, for `msmv_sample_fold`'s arguments."""
    L = len(true_hws)
    S, Q, P = x_norm.shape
    rows, x0s, wxs, wys = [], [], [], []
    for l, (H, W) in enumerate(true_hws):
        x_pix = x_norm * (W - 1)
        y_pix = y_norm * (H - 1)
        x0 = torch.floor(x_pix)
        y0 = torch.floor(y_pix)
        wxs.append((x_pix - x0).float())
        wys.append((y_pix - y0).float())
        x0s.append(x0.clamp(-PAD, W).to(torch.int32) + PAD)
        y0p = y0.clamp(-PAD, H).to(torch.int32) + PAD
        rows.append(view.to(torch.int32) * rcat + roffs[l] + y0p)

    def inter(parts):  # L x [S, Q, P] -> [S, Q*P*L]
        return torch.stack(parts, dim=-1).reshape(S, Q * P * L)

    return (inter(rows), inter(x0s), inter(wxs), inter(wys),
            weights.float().contiguous().reshape(S, Q * P * L))


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
