"""Hungarian set matching for the DETR-style loss (port of
`racformer_tpu/train/matching.py`: `match_cost`, `match_cost_cartesian`,
`_lap_single`, `hungarian_assign`).

The cost is computed on the device. The assignment is the JAX package's
Jonker-Volgenant shortest-augmenting-path algorithm in float32, step for
step, so the assignments are the JAX package's (the reference runs scipy on
the host at the same place). `lap_single` / `assign_host` run it on the host
in numpy; on a CUDA device `hungarian_assign` launches the CUDA kernel
`csrc/lap_assign.cu`, which runs the same steps, on the current stream and
without waiting for the device, as the JAX package runs it in its graph.
CPU tensors, and CUDA tensors inside `gather_kernel.force_reference()`,
take `assign_host`. `LAP_LAUNCHES` counts the kernel's launches; the span
open around a call (`train.matching` in the loss) counts the problems
solved as `device_assigns` or `host_assigns`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import device_constant
from ..ops import gather_kernel as gk
from ..ops.bbox_codec import normalize_bbox
from ..utils import tracing

BIG = 1.0e8
_INF = np.float32(1.0e18)
LAP_LAUNCHES = 0  # `hungarian_assign` calls that launched the CUDA kernel
# the kernel keeps the state of Q + 1 columns in 256 threads' registers, at
# most 32 columns a thread
_MAX_COLUMNS = 32 * 256


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
    cw = device_constant(tuple(code_weights), bbox_preds.device,
                         bbox_preds.dtype)
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


def match_cost_cartesian(cls_scores, bbox_preds, gt_bboxes, gt_labels,
                         gt_mask, code_weights=None, cls_weight=2.0,
                         reg_weight=0.25, with_velo=True, alpha=0.25,
                         gamma=2.0):
    """The non-polar `HungarianAssigner3D` cost: focal class cost plus the
    (code-weighted) L1 on cartesian normalized boxes, no angular term;
    `with_velo=False` keeps the first 8 box dims only. Shapes and contract
    as `match_cost`'s."""
    eps = 1e-12
    p = torch.sigmoid(cls_scores)
    pos_cost = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    idx = gt_labels.long()[..., None, :].expand(*p.shape[:-1], gt_labels.shape[-1])
    cls_cost = torch.gather(pos_cost - neg_cost, -1, idx) * cls_weight
    pred_w, gt_w = bbox_preds, normalize_bbox(gt_bboxes)
    if code_weights is not None:
        cw = device_constant(tuple(code_weights), bbox_preds.device,
                             bbox_preds.dtype)
        pred_w, gt_w = pred_w * cw, gt_w * cw
    d = 10 if with_velo else 8
    reg_cost = (pred_w[..., :, None, :d] - gt_w[..., None, :, :d]).abs().sum(-1)
    cost = torch.nan_to_num(cls_cost + reg_cost * reg_weight, nan=100.0,
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


def assign_host(cost: np.ndarray) -> np.ndarray:
    """cost: host [..., Q, G] float32 -> matched query of each GT [..., G]
    (int32)."""
    *batch, Q, G = cost.shape
    out = np.stack([lap_single(c.T) for c in cost.reshape(-1, Q, G)])
    return out.reshape(*batch, G)


def _check_cost(cost: torch.Tensor) -> None:
    """Raise unless `cost` is what both solvers take: [..., Q, G] float32,
    contiguous, G <= Q, at most `_MAX_COLUMNS` - 1 queries."""
    if cost.dim() < 2:
        raise ValueError(f"hungarian_assign: cost must be [..., Q, G], got "
                         f"{tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"hungarian_assign: cost must be float32, got "
                        f"{cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("hungarian_assign: cost must be contiguous")
    Q, G = cost.shape[-2:]
    if G > Q:
        raise ValueError(f"hungarian_assign: G={G} GT rows exceed Q={Q} "
                         f"queries")
    if Q + 1 > _MAX_COLUMNS:
        raise ValueError(f"hungarian_assign: Q={Q} queries do not fit the "
                         f"kernel's {_MAX_COLUMNS} columns of state")


def hungarian_assign(cost: torch.Tensor) -> torch.Tensor:
    """cost: [..., Q, G] float32, contiguous, G <= Q -> the matched query of
    each GT [..., G] (int64, on the cost's device). On CUDA the kernel runs
    on the current stream and nothing waits for it; on the CPU, or inside
    `gather_kernel.force_reference()`, `assign_host` runs on a host copy."""
    global LAP_LAUNCHES
    _check_cost(cost)
    *batch, Q, G = cost.shape
    problems = math.prod(batch)
    if gk.use_reference(cost):
        tracing.count("host_assigns", problems)
        host = cost.detach().cpu().numpy()
        return torch.from_numpy(assign_host(host).astype(np.int64)).to(cost.device)
    matched = torch.empty((*batch, G), dtype=torch.int64, device=cost.device)
    # the transposed rows the kernel's shared memory does not hold
    scratch = torch.empty((problems, G, Q), dtype=torch.float32,
                          device=cost.device)
    gk.launch("lap_assign", cost.data_ptr(), scratch.data_ptr(),
              matched.data_ptr(), problems, Q, G, gk.current_stream(cost))
    LAP_LAUNCHES += 1
    tracing.count("device_assigns", problems)
    return matched
