"""The training step (port of `racformer_tpu/train/step.py::make_train_step`):
augmentation, the train-mode forward, the losses, the backward, gradient
accumulation over microbatches and the optimizer update, on one device.

Accumulation splits the batch interleaved (sample i -> microbatch i % A, as
the JAX step does) and normalizes every microbatch's set, DN and depth
losses by the FULL batch's positive / foreground counts divided by A, so
the mean of the microbatch gradients is exactly the full-batch gradient.
BatchNorm running statistics carry from one microbatch to the next.

The random draws of a step (photometric distortion, GridMask, query
denoising, dropout) come from one `torch.Generator` per step; a caller may
also pass the draws of each microbatch explicitly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..model.augment import (grid_mask, grid_mask_draws, photometric_distortion,
                             photometric_draws)
from ..model.racformer import RaCFormer, preprocess_images
from ..nn.head import dn_draws
from ..nn.layers import DropoutRNG, dropout_rng
from .losses import depth_fg_count, depth_loss, detection_loss
from .optim import Optimizer

MODEL_KEYS = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
              "lidar2img", "img2lidar", "time_diff")
DEPTH_KEYS = ("d_lo", "d_hi", "num_bins", "downsample")


def make_draws(model: RaCFormer, micro: Dict, generator: torch.Generator,
               dropout: bool = True) -> Dict:
    """The random draws of one microbatch: photometric distortion (per
    sample), GridMask (per microbatch), the query-denoising noise and a
    dropout seed (None: dropout off)."""
    B = micro["imgs"].shape[0]
    head = model.pts_bbox_head
    return {
        "photo": photometric_draws(B, generator),
        "grid": grid_mask_draws(model.image_hw[0], generator),
        "dn": dn_draws(B, micro["gt_bboxes"].shape[1], head.dn_groups,
                       head.num_classes, generator),
        "dropout_seed": (int(torch.randint(0, 2**62, (1,), generator=generator))
                         if dropout else None),
    }


def split_microbatches(batch: Dict, accum_steps: int) -> List[Dict]:
    """Interleaved split: sample i goes to microbatch i % accum_steps."""
    B = batch["imgs"].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} is not divisible by accum_steps="
                         f"{accum_steps}")
    return [{k: v[a::accum_steps] for k, v in batch.items()}
            for a in range(accum_steps)]


def make_train_step(model: RaCFormer, optimizer: Optimizer,
                    depth_cfg: Optional[Dict] = None, accum_steps: int = 1,
                    match_stats: bool = False, loss_scale: float = 0.0):
    """Returns train_step(batch, generator=None, draws=None,
    depth_weight=2.0) -> metrics.

    batch: tensors on the model's device with the keys of
    `racformer_tpu.data.SyntheticDataset` (imgs raw 0-255 BGR
    [B, T, N, H, W, 3], the model inputs, gt_bboxes / gt_labels / gt_mask,
    optionally gt_depth [B, N, H, W]). `draws` (one `make_draws` dict per
    microbatch) replaces the draws from `generator`. Metrics are the JAX
    step's: every loss term averaged over the microbatches, and
    'grad_norm', the global norm of the averaged gradients before clipping
    (frozen parameters included).

    `match_stats=True` adds the Hungarian assignment of every decoder layer
    as host arrays '_matched_q' / '_match_cost' [L, B, G] in the batch's
    sample order (`losses.detection_loss`); underscore keys are not
    averaged. `loss_scale > 0` is the reference's static fp16 loss scaling:
    each microbatch's objective is multiplied by it before `backward()` and
    every gradient divided by it before the optimizer clips, so
    'grad_norm' is the unscaled norm."""
    depth_cfg = dict(depth_cfg or {})
    loss_scale = float(loss_scale or 0.0)
    depth_kw = {k: v for k, v in depth_cfg.items() if k in DEPTH_KEYS}

    def loss_fn(micro, draws, depth_weight, pos_norm, fg_norm):
        imgs = photometric_distortion(micro["imgs"], _to(draws["photo"], micro))
        imgs = grid_mask(imgs, draws["grid"])
        seed = draws.get("dropout_seed")
        rng = None if seed is None else DropoutRNG(seed, imgs.device)
        with dropout_rng(rng):
            outs = model(preprocess_images(imgs), *[micro[k] for k in MODEL_KEYS],
                         gt_bboxes=micro["gt_bboxes"],
                         gt_labels=micro["gt_labels"], gt_mask=micro["gt_mask"],
                         dn=_to(draws["dn"], micro))
        losses = detection_loss(outs, micro["gt_bboxes"], micro["gt_labels"],
                                micro["gt_mask"], num_classes=model.num_classes,
                                with_match=match_stats, pos_norm=pos_norm)
        if "gt_depth" in micro:
            ld = depth_loss(outs["depth_logits"], micro["gt_depth"], **depth_kw,
                            weight=1.0, fg_norm=fg_norm) * depth_weight
            losses["loss_depth"] = ld
            losses["loss_total"] = losses["loss_total"] + ld
        return losses

    def train_step(batch: Dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[List[Dict]] = None, depth_weight=2.0):
        model.train()
        micros = split_microbatches(batch, accum_steps)
        if draws is None:
            draws = [make_draws(model, m, generator) for m in micros]
        pos_norm = batch["gt_mask"].sum().float().clamp(min=1.0) / accum_steps
        fg_norm = None
        if "gt_depth" in batch:
            fg_norm = depth_fg_count(batch["gt_depth"], **depth_kw).clamp(
                min=1.0) / accum_steps
        optimizer.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        aux: Dict[str, List[np.ndarray]] = {}
        for micro, d in zip(micros, draws):
            losses = loss_fn(micro, d, depth_weight, pos_norm, fg_norm)
            objective = losses["loss_total"] / accum_steps
            if loss_scale > 0:
                objective = objective * loss_scale
            objective.backward()
            for k, v in losses.items():
                if k.startswith("_"):
                    aux.setdefault(k, []).append(v)
                else:
                    sums[k] = sums.get(k, 0.0) + v.detach()
        metrics = {k: v / accum_steps for k, v in sums.items()}
        # undo the interleave: microbatch a, row p was sample p * A + a
        for k, parts in aux.items():
            stacked = np.stack(parts, axis=2)  # [L, B / A, A, G]
            metrics[k] = stacked.reshape(stacked.shape[0], -1,
                                         *stacked.shape[3:])
        if loss_scale > 0:
            grads = [p.grad for p in optimizer.params.values()
                     if p.grad is not None]
            torch._foreach_div_(grads, loss_scale)
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return train_step


def _to(tree, like):
    """Move a dict of draws to the microbatch's device."""
    dev = like["imgs"].device
    return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in tree.items()}

