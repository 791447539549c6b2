"""Batched offline evaluation (port of `racformer_tpu/eval/offline.py`):
the whole T-frame window of every sample through the model's forward,
batches of `batch_size` samples per rank, the tail padded with the last
sample and dropped after the box decode. With several ranks
(`utils.distributed`) each loads its rows of every global batch, as the JAX
evaluator's processes do over the data mesh, and the predictions are
gathered so that every rank returns all of them. Also the ground-truth
extraction and the metric dispatch shared by the eval driver's three
protocols.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..model import preprocess_images
from ..utils import distributed
from .decode import decode_boxes, decode_config

ARG_KEYS = ("imgs", "radar_points", "radar_mask", "radar_depth", "radar_rcs",
            "lidar2img", "img2lidar", "time_diff")

_GT_OPTIONAL = (("gt_attrs", "attrs"), ("gt_num_pts", "num_pts"),
                ("ego_xy", "ego_xy"), ("gt_in_bikerack", "in_bikerack"),
                ("gt_bikeracks", "bikeracks"))


def synchronize(device: torch.device):
    """Wait for the device's work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gather_gt(sample_batch: Dict, j: int) -> Optional[Dict]:
    """Extract sample j's ground-truth dict (metrics.py schema) from a
    collated batch; None when the dataset carries no GT."""
    if "gt_bboxes" not in sample_batch:
        return None
    g = dict(bboxes=sample_batch["gt_bboxes"][j],
             labels=sample_batch["gt_labels"][j],
             mask=sample_batch["gt_mask"][j])
    for src, dst in _GT_OPTIONAL:
        if src in sample_batch:
            g[dst] = sample_batch[src][j]
    return g


def gather_gt_sample(s: Dict) -> Optional[Dict]:
    """`gather_gt` for one UNCOLLATED sample dict: the extraction point of
    the per-sample eval loops (single-stream and multi-stream streaming)."""
    if "gt_bboxes" not in s:
        return None
    g = dict(bboxes=s["gt_bboxes"], labels=s["gt_labels"], mask=s["gt_mask"])
    for src, dst in _GT_OPTIONAL:
        if src in s:
            g[dst] = s[src]
    return g


class OfflineEvaluator:
    """The offline protocol on the model's device: each batch's window
    encoded and decoded whole, boxes decoded with the configuration the
    streaming evaluator uses (`decode.decode_config`)."""

    def __init__(self, model, eval_cfg: Optional[Dict] = None,
                 batch_size: int = 1):
        self.model = model
        self.device = next(model.parameters()).device
        self.batch = max(1, int(batch_size))
        self.decode_cfg = decode_config(eval_cfg)

    @torch.no_grad()
    def predict(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """b: ARG_KEYS as [B, T, ...] tensors on the device (imgs raw 0-255
        BGR). Returns the decoded boxes as device tensors."""
        outs = self.model(preprocess_images(b["imgs"]),
                          *[b[k] for k in ARG_KEYS[1:]])
        return decode_boxes(outs["all_cls_scores"][-1],
                            outs["all_bbox_preds"][-1], **self.decode_cfg)

    def run(self, dataset, max_samples: Optional[int] = None
            ) -> Tuple[List[Dict], List[Dict], float]:
        """Returns (preds, gts, samples_per_sec); the first batch is left
        out of the timing (it pays for cuDNN's algorithm choice and the
        kernels' first loads).

        With W ranks a global batch is W * batch_size samples (the tail
        padded with the last sample), rank r loads rows [r * batch_size,
        (r + 1) * batch_size) of it, and every rank returns the (preds,
        gts) of every sample in dataset order, gathered after each batch:
        the metrics, and any decision taken on them, agree on every
        rank. Each batch is timed from its forward through the gather of
        its rows, and the rate is the valid samples over the slowest
        rank's time."""
        num = len(dataset)
        if max_samples:
            num = min(num, int(max_samples))
        preds: List[Dict] = []
        gts: List[Dict] = []
        t_total, n = 0.0, 0
        world, rank = distributed.world(), distributed.rank()
        local = self.batch
        B = local * world
        for start in range(0, num, B):
            valid = min(start + B, num) - start
            idxs = list(range(start, start + valid))
            idxs += [idxs[-1]] * (B - valid)
            sb = dataset.batch(idxs[rank * local:(rank + 1) * local])
            b = {k: torch.from_numpy(np.ascontiguousarray(sb[k])).to(self.device)
                 for k in ARG_KEYS}
            t0 = time.perf_counter()
            out = self.predict(b)
            synchronize(self.device)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            rows = [({k: v[j] for k, v in out.items()}, gather_gt(sb, j))
                    for j in range(local)]
            if world > 1:  # every rank's rows, in rank order
                rows = [r for part in distributed.all_gather_object(rows)
                        for r in part]
            if start > 0:
                t_total += time.perf_counter() - t0
                n += valid
            for p, g in rows[:valid]:
                preds.append(p)
                if g is not None:
                    gts.append(g)
        if world > 1:
            t_total = max(distributed.all_gather_object(t_total))
        return preds, gts, (n / t_total if t_total > 0 else 0.0)


def label_pred_attributes(preds: List[Dict], class_names) -> None:
    """Attach predicted attributes in-place via mmdet3d's velocity-aware rule
    (the convention behind the reference's devkit submissions), coded into
    the same vocabulary as the baked GT attributes."""
    from ..tools.export_results import attribute_for
    from ..tools.gen_sweep_info import ATTRIBUTES

    names = list(class_names)
    for p in preds:
        boxes = np.asarray(p["bboxes"])
        labels = np.asarray(p["labels"])
        p["attrs"] = np.asarray([
            ATTRIBUTES.index(attribute_for(
                names[int(l)], float(b[7]), float(b[8])))
            for b, l in zip(boxes, labels)
        ], np.int32)


def detection_metrics(preds: List[Dict], gts: List[Dict], *,
                      is_vod: bool = False, class_names=None,
                      front_only: bool = False, return_curves: bool = False,
                      gt_filter=None) -> Dict:
    """Protocol dispatch: VoD KITTI metrics or nuScenes NDS/mAP (with
    predicted-attribute labeling when the config provides class names)."""
    if is_vod:
        from .kitti_eval import kitti_vod_metrics

        vp = [
            {"bboxes": np.asarray(p["bboxes"])[np.asarray(p["valid"], bool)][:, :7],
             "scores": np.asarray(p["scores"])[np.asarray(p["valid"], bool)],
             "labels": np.asarray(p["labels"])[np.asarray(p["valid"], bool)]}
            for p in preds
        ]
        vg = [{"bboxes": np.asarray(g["bboxes"])[np.asarray(g["mask"], bool), :7],
               "labels": np.asarray(g["labels"])[np.asarray(g["mask"], bool)]}
              for g in gts]
        return kitti_vod_metrics(vp, vg)

    from .metrics import nuscenes_metrics

    if class_names:
        label_pred_attributes(preds, class_names)
    return nuscenes_metrics(preds, gts, front_only=front_only,
                            return_curves=return_curves, gt_filter=gt_filter)
