"""Hungarian set matching for the DETR-style loss (port of
`racformer_tpu/train/matching.py`: `match_cost`, `_lap_single`,
`hungarian_assign`).

The cost is computed on the device; the assignment runs on the host on the
detached [L, B, Q, G] cost, copied once per call, with the JAX package's
Jonker-Volgenant shortest-augmenting-path algorithm in float32, step for
step, so the assignments are the JAX package's (the reference runs scipy on
the host at the same place).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.bbox_codec import normalize_bbox

BIG = 1.0e8
_INF = np.float32(1.0e18)


def match_cost(cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_mask,
               code_weights, cls_weight=2.0, reg_weight=0.25, theta_weight=3.0,
               alpha=0.25, gamma=2.0):
    """cls_scores: [..., Q, C] logits; bbox_preds: [..., Q, 10]
    normalized-layout predictions; gt_bboxes: [..., G, 9] raw; gt_labels /
    gt_mask: [..., G]. Returns the cost [..., Q, G]: focal class cost,
    code-weighted L1 and the wrap-around angular cost; invalid GT columns
    cost BIG, NaN costs 100."""
    eps = 1e-12
    p = torch.sigmoid(cls_scores)
    pos_cost = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    idx = gt_labels.long()[..., None, :].expand(*p.shape[:-1], gt_labels.shape[-1])
    cls_cost = torch.gather(pos_cost - neg_cost, -1, idx) * cls_weight
    cw = torch.as_tensor(code_weights, dtype=bbox_preds.dtype,
                         device=bbox_preds.device)
    pred_w = bbox_preds * cw
    gt_w = normalize_bbox(gt_bboxes) * cw
    reg_cost = (pred_w[..., :, None, :] - gt_w[..., None, :, :]).abs().sum(-1)
    reg_cost = reg_cost * reg_weight
    two_pi = 2 * math.pi
    tp = torch.remainder(torch.atan2(pred_w[..., 1], pred_w[..., 0]) + two_pi,
                         two_pi) / two_pi
    tg = torch.remainder(torch.atan2(gt_w[..., 1], gt_w[..., 0]) + two_pi,
                         two_pi) / two_pi
    dt = (tp[..., :, None] - tg[..., None, :]).abs()
    theta_cost = (torch.remainder(dt + 0.5, 1.0) - 0.5).abs() * theta_weight
    cost = torch.nan_to_num(cls_cost + reg_cost + theta_cost, nan=100.0,
                            posinf=100.0, neginf=-100.0)
    return torch.where(gt_mask[..., None, :], cost, torch.full_like(cost, BIG))


def lap_single(cost_gq: np.ndarray) -> np.ndarray:
    """Exact linear assignment of one [G, Q] cost matrix (G <= Q): the
    e-maxx Jonker-Volgenant formulation with a virtual column 0, in float32
    as the JAX `_lap_single` runs it. Returns the matched query of each row
    [G] (int32)."""
    G, Q = cost_gq.shape
    cost = np.zeros((G + 1, Q + 1), np.float32)
    cost[1:, 1:] = cost_gq
    u = np.zeros(G + 1, np.float32)
    v = np.zeros(Q + 1, np.float32)
    p = np.zeros(Q + 1, np.int64)  # column -> row
    for i in range(1, G + 1):
        p[0] = i
        minv = np.full(Q + 1, _INF, np.float32)
        way = np.zeros(Q + 1, np.int64)
        used = np.zeros(Q + 1, bool)
        j0 = 0
        while p[j0] != 0:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0] - u[i0] - v
            better = ~used & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            masked = np.where(used, _INF, minv)
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            u[p[used]] += delta
            v = v - np.where(used, delta, np.float32(0.0))
            minv = np.where(used, minv, minv - delta)
            j0 = j1
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    match = np.zeros(G + 1, np.int64)
    cols = np.arange(Q + 1)
    match[p[p > 0]] = cols[p > 0]
    return (match[1:] - 1).astype(np.int32)


def hungarian_assign(cost: torch.Tensor) -> torch.Tensor:
    """cost: [..., Q, G] -> matched query of each GT [..., G] (int64, on
    the cost's device). One device-to-host copy of the detached cost."""
    *batch, Q, G = cost.shape
    flat = cost.detach().float().cpu().numpy().reshape(-1, Q, G)
    out = np.stack([lap_single(c.T) for c in flat])
    return torch.from_numpy(out.astype(np.int64)).reshape(*batch, G).to(
        cost.device)
