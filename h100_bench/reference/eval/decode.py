"""NMS-free box decoding (port of `racformer_tpu/eval/decode.py`): sigmoid
scores, flat top-k across (query x class), denormalize, score threshold,
post-center range filter on gravity centers, then the z-shift to bottom
centers. Shapes stay fixed: max_num boxes plus a validity mask."""

from __future__ import annotations

import math

import torch

from ..ops.bbox_codec import denormalize_bbox


def decode_config(eval_cfg=None) -> dict:
    """`decode_boxes`' keyword arguments from a config's `eval_cfg`: the one
    box-decode configuration, shared by the streaming and offline
    evaluators, so a knob cannot apply to one protocol and not the other."""
    ecfg = eval_cfg or {}
    return dict(
        max_num=ecfg.get("max_num", 300),
        score_threshold=ecfg.get("score_threshold", 0.05),
        post_center_range=tuple(ecfg.get(
            "post_center_range", (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0))),
        legacy_version=ecfg.get("legacy_version", "v1.0.0"))


def decode_boxes(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                 max_num: int = 300, score_threshold: float = 0.05,
                 post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
                 legacy_version: str = "v1.0.0"):
    """cls_scores: [B, Q, C] logits (last decoder layer); bbox_preds:
    [B, Q, 10]. Returns dict(bboxes [B, max_num, 9], scores [B, max_num],
    labels [B, max_num], valid [B, max_num]); boxes use the lidar
    bottom-center convention. `legacy_version='v0.17.1'` applies the legacy
    mmdet3d flip (w/l swap, yaw := -yaw - pi/2)."""
    B, Q, C = cls_scores.shape
    max_num = min(max_num, Q * C)
    scores = torch.sigmoid(cls_scores.float()).reshape(B, Q * C)
    # NaN must not reach top-k: -inf is never selected and fails the threshold
    scores = torch.where(torch.isfinite(scores), scores,
                         torch.full_like(scores, -math.inf))
    top_scores, idx = torch.topk(scores, max_num, dim=-1)
    labels = idx % C
    box_idx = idx // C
    boxes = torch.gather(bbox_preds.float(), 1,
                         box_idx[..., None].expand(-1, -1, bbox_preds.shape[-1]))
    boxes = denormalize_bbox(boxes)  # [B, max_num, 9]
    lim = torch.tensor(post_center_range, device=boxes.device)
    in_range = ((boxes[..., :3] >= lim[:3]).all(-1)
                & (boxes[..., :3] <= lim[3:]).all(-1))
    z = boxes[..., 2:3] - 0.5 * boxes[..., 5:6]
    boxes = torch.cat([boxes[..., 0:2], z, boxes[..., 3:]], dim=-1)
    if legacy_version == "v0.17.1":
        boxes = torch.cat([boxes[..., 0:3], boxes[..., 4:5], boxes[..., 3:4],
                           boxes[..., 5:6], -boxes[..., 6:7] - math.pi / 2,
                           boxes[..., 7:9]], dim=-1)
    valid = (top_scores > score_threshold) & in_range
    return {"bboxes": boxes, "scores": top_scores, "labels": labels,
            "valid": valid}
