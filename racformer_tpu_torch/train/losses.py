"""Detection losses (port of `racformer_tpu/train/losses.py`): set-based
focal + L1 over all decoder layers after Hungarian matching, the query
denoising (DN) losses, and the SID depth focal loss.

`pos_norm` / `fg_norm` override the positive-count and foreground-count
normalizers: gradient accumulation passes the FULL batch's counts divided by
the number of microbatches, so that the mean of the microbatch losses is
exactly the full-batch loss.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import device_constant
from ..ops.bbox_codec import normalize_bbox
from ..ops.depth_bins import depth_to_sid_index
from ..utils import tracing
from .matching import hungarian_assign, match_cost

CODE_WEIGHTS = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def sigmoid_focal_loss(logits, labels, num_classes, alpha=0.25, gamma=2.0):
    """Per-element sigmoid focal loss summed over classes; labels ==
    num_classes is background."""
    y = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].to(
        logits.dtype)
    p = torch.sigmoid(logits)
    ce_pos = -F.logsigmoid(logits)
    ce_neg = -F.logsigmoid(-logits)
    loss = (alpha * y * (1 - p) ** gamma * ce_pos
            + (1 - alpha) * (1 - y) * p ** gamma * ce_neg)
    return loss.sum(-1)


def categorical_focal_loss(logits, labels, alpha=0.25, gamma=2.0):
    """Softmax focal loss of the depth bins."""
    logp = torch.log_softmax(logits, dim=-1)
    logpt = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    pt = torch.exp(logpt)
    return -alpha * (1 - pt) ** gamma * logpt


def _depth_fg_labels(gt_depth, d_lo, d_hi, num_bins, downsample):
    B, N, H, W = gt_depth.shape
    d = torch.where(gt_depth == 0.0, torch.full_like(gt_depth, 1e5), gt_depth)
    d = d.reshape(B, N, H // downsample, downsample, W // downsample,
                  downsample).amin(dim=(3, 5))
    labels = depth_to_sid_index(d, d_lo, d_hi, num_bins)
    return labels, labels < num_bins


def depth_fg_count(gt_depth, d_lo=1.0, d_hi=65.0, num_bins=96, downsample=16):
    """Number of foreground depth cells, the normalizer of `depth_loss`."""
    _, fg = _depth_fg_labels(gt_depth, d_lo, d_hi, num_bins, downsample)
    return fg.sum().float()


def depth_loss(depth_logits, gt_depth, d_lo=1.0, d_hi=65.0, num_bins=96,
               downsample=16, weight=2.0, fg_norm=None):
    """depth_logits: [B, N, Hf, Wf, D]; gt_depth: [B, N, H, W] sparse depth
    (0 = missing): min-pooled to the feature stride, SID-quantized, focal
    loss on the foreground cells."""
    labels, fg = _depth_fg_labels(gt_depth, d_lo, d_hi, num_bins, downsample)
    safe = torch.where(fg, labels, torch.zeros_like(labels))
    loss = categorical_focal_loss(depth_logits.float(), safe)
    loss = torch.where(fg, loss, torch.zeros_like(loss)).sum()
    norm = fg.sum().float().clamp(min=1.0) if fg_norm is None else fg_norm
    return weight * loss / norm


def _l1_loss(preds, targets, weights, norm):
    """0.25 * code-weighted L1 over finite targets, / norm."""
    cw = device_constant(CODE_WEIGHTS, preds.device)
    finite = torch.isfinite(targets).all(-1, keepdim=True)
    t = torch.nan_to_num(targets, nan=0.0, posinf=0.0, neginf=0.0)
    return 0.25 * ((preds.float() - t).abs() * weights * cw * finite).sum() / norm


def detection_loss(outs: Dict, gt_bboxes, gt_labels, gt_mask, num_classes=10,
                   with_match: bool = False,
                   pos_norm: Optional[torch.Tensor] = None) -> Dict:
    """The head loss over all decoder layers, plus the DN losses when `outs`
    holds DN outputs. gt_bboxes: [B, G, 9] raw boxes; gt_labels: [B, G];
    gt_mask: [B, G]. Keys as the JAX package's: 'd{l}.loss_cls',
    'd{l}.loss_bbox' (and '_dn' variants) for the inner layers, 'loss_cls',
    'loss_bbox' for the last, and 'loss_total'.

    `with_match=True` adds each layer's Hungarian assignment as host
    arrays: '_matched_q' [L, B, G] int32, the query matched to each GT, and
    '_match_cost' [L, B, G] float32, that pair's cost (the match statistics
    `hooks.MatchStatsHook` dumps). Underscore keys are diagnostics, not
    losses. Only these copy to the host: on a CUDA device the loss is
    otherwise built without waiting for the device (`hungarian_assign`)."""
    cls_scores = outs["all_cls_scores"]  # [L, B, Q, C]
    bbox_preds = outs["all_bbox_preds"]  # [L, B, Q, 10]
    L, B, Q, _ = cls_scores.shape
    G = gt_bboxes.shape[1]
    dev = cls_scores.device
    safe_labels = torch.where(gt_mask, gt_labels, torch.zeros_like(gt_labels))
    with torch.no_grad():
        cost = match_cost(cls_scores.float(), bbox_preds.float(),
                          gt_bboxes[None], safe_labels[None], gt_mask[None],
                          CODE_WEIGHTS)  # [L, B, Q, G]
    with tracing.span("train.matching", gt_rows=L * B * G):
        matched = hungarian_assign(cost)  # [L, B, G] int64 on dev
    gt_norm = normalize_bbox(gt_bboxes)  # [B, G, 10]

    # scatter the GT onto the matched queries; invalid GT go to a dropped
    # extra slot Q
    safe_q = torch.where(gt_mask[None], matched,
                         torch.full_like(matched, Q))  # [L, B, G]
    labels = torch.full((L, B, Q + 1), num_classes, dtype=torch.long,
                        device=dev)
    labels.scatter_(2, safe_q, safe_labels.long()[None].expand(L, B, G))
    targets = torch.zeros((L, B, Q + 1, 10), device=dev)
    targets.scatter_(2, safe_q[..., None].expand(L, B, G, 10),
                     gt_norm[None].expand(L, B, G, 10).float())
    weights = torch.zeros((L, B, Q + 1, 1), device=dev)
    weights.scatter_(2, safe_q[..., None], torch.ones((L, B, G, 1), device=dev))
    labels, targets, weights = labels[:, :, :Q], targets[:, :, :Q], weights[:, :, :Q]

    num_pos = gt_mask.sum().float()
    set_norm = num_pos.clamp(min=1.0) if pos_norm is None else pos_norm
    losses, total = {}, 0.0
    for l in range(L):
        key = "loss" if l == L - 1 else f"d{l}.loss"
        lc = 2.0 * sigmoid_focal_loss(cls_scores[l].float(), labels[l],
                                      num_classes).sum() / set_norm
        lb = _l1_loss(bbox_preds[l], targets[l], weights[l], set_norm)
        losses[f"{key}_cls"] = torch.nan_to_num(lc)
        losses[f"{key}_bbox"] = torch.nan_to_num(lb)
        total = total + losses[f"{key}_cls"] + losses[f"{key}_bbox"]

    if "dn_cls_scores" in outs:
        dn_cls, dn_box = outs["dn_cls_scores"], outs["dn_bbox_preds"]
        dn_valid = outs["dn_valid"]  # [B, S]
        ngroup = dn_valid.shape[1] // G
        # slot s is GT s % G; the targets are the clean GT
        tgt_labels = safe_labels.repeat(1, ngroup)
        tgt_boxes = gt_norm.repeat(1, ngroup, 1).float()
        dn_norm = (dn_valid.sum().float().clamp(min=1.0) if pos_norm is None
                   else pos_norm * ngroup)
        lbl = torch.where(dn_valid, tgt_labels,
                          torch.full_like(tgt_labels, num_classes))
        vw = dn_valid[..., None].float()
        for l in range(L):
            key = "loss" if l == L - 1 else f"d{l}.loss"
            focal = sigmoid_focal_loss(dn_cls[l].float(), lbl, num_classes)
            lc = 2.0 * torch.where(dn_valid, focal,
                                   torch.zeros_like(focal)).sum() / dn_norm
            lb = _l1_loss(dn_box[l], tgt_boxes, vw, dn_norm)
            losses[f"{key}_cls_dn"] = torch.nan_to_num(lc)
            losses[f"{key}_bbox_dn"] = torch.nan_to_num(lb)
            total = total + losses[f"{key}_cls_dn"] + losses[f"{key}_bbox_dn"]
    losses["loss_total"] = total
    if with_match:
        pair_cost = torch.gather(cost, 2, matched[:, :, None, :])[:, :, 0, :]
        losses["_matched_q"] = matched.cpu().numpy().astype(np.int32)
        losses["_match_cost"] = pair_cost.cpu().numpy()
    return losses
