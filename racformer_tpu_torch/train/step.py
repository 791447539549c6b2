"""The training step (port of `racformer_tpu/train/step.py::make_train_step`):
augmentation, the train-mode forward, the losses, the backward, gradient
accumulation over microbatches and the optimizer update, on one device or,
under `DistributedDataParallel`, on each of several ranks.

Accumulation splits the batch interleaved (sample i -> microbatch i % A, as
the JAX step does) and normalizes every microbatch's set, DN and depth
losses by the FULL batch's positive / foreground counts divided by A, so
the mean of the microbatch gradients is exactly the full-batch gradient.
BatchNorm running statistics carry from one microbatch to the next.

The random draws of a step (photometric distortion, GridMask, query
denoising, dropout) come from one `torch.Generator` per step; a caller may
also pass the draws of each microbatch explicitly.

With several ranks (`utils.distributed`), each holds rows [r*b, (r+1)*b) of
the global batch. With b a multiple of A, the union of the ranks'
microbatch a, in rank order, is the global batch's microbatch a, as the
JAX step splits it. The positive and foreground counts are those of the
global batch, so each rank's loss is its part of the global loss. The
gradients are summed over the ranks, once per step: every microbatch but
the last runs under `no_sync()`. The logged losses are summed too, so every
rank logs the global batch's. The per-sample draws are this rank's rows of
the global draws, which every rank makes alike. The dropout masks are
drawn from a seed of the rank's own, so they depend on the layout: the JAX
package's one `rbg` key over a sharded batch does not give the same masks
on another layout either.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..model.augment import (grid_mask, grid_mask_draws, photometric_distortion,
                             photometric_draws)
from ..model.racformer import RaCFormer, preprocess_images
from ..nn.head import dn_draws
from ..nn.layers import DropoutRNG, dropout_rng
from ..utils import distributed, tracing
from .losses import depth_fg_count, depth_loss, detection_loss
from .optim import Optimizer

MODEL_KEYS = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
              "lidar2img", "img2lidar", "time_diff")
DEPTH_KEYS = ("d_lo", "d_hi", "num_bins", "downsample")


def make_draws(model: RaCFormer, micro: Dict, generator: torch.Generator,
               dropout: bool = True, world: int = 1, rank: int = 0) -> Dict:
    """The random draws of one microbatch: photometric distortion (per
    sample), GridMask (per microbatch), the query-denoising noise and a
    dropout seed (None: dropout off).

    With `world` ranks: the draws of the global microbatch (`world` times
    this one's rows), which every rank makes alike from its generator, cut
    to rank `rank`'s rows, and a dropout seed of the rank's own."""
    B = micro["imgs"].shape[0]
    head = model.pts_bbox_head
    draws = {
        "photo": photometric_draws(B * world, generator),
        "grid": grid_mask_draws(model.image_hw[0], generator),
        "dn": dn_draws(B * world, micro["gt_bboxes"].shape[1], head.dn_groups,
                       head.num_classes, generator),
        "dropout_seed": (int(torch.randint(0, 2**62, (1,), generator=generator))
                         if dropout else None),
    }
    if world > 1:
        lo = rank * B
        for k in ("photo", "dn"):
            draws[k] = {n: v[lo:lo + B] for n, v in draws[k].items()}
        if draws["dropout_seed"] is not None:
            draws["dropout_seed"] = int(np.random.SeedSequence(
                [draws["dropout_seed"], rank]).generate_state(
                    1, np.uint64)[0] >> 2)
    return draws


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
                    match_stats: bool = False, loss_scale: float = 0.0,
                    ddp=None):
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
    'grad_norm' is the unscaled norm.

    `ddp`: `model` wrapped in `DistributedDataParallel` with
    `sum_gradients` as its communication hook; the forward goes through it.
    `batch` is then this rank's rows of the global batch, and 'grad_norm'
    the norm of the summed gradients."""
    depth_cfg = dict(depth_cfg or {})
    loss_scale = float(loss_scale or 0.0)
    depth_kw = {k: v for k, v in depth_cfg.items() if k in DEPTH_KEYS}
    net = model if ddp is None else ddp

    def loss_fn(micro, draws, depth_weight, pos_norm, fg_norm):
        with tracing.span("train.forward"):
            imgs = photometric_distortion(micro["imgs"], _to(draws["photo"], micro))
            imgs = grid_mask(imgs, draws["grid"])
            seed = draws.get("dropout_seed")
            rng = None if seed is None else DropoutRNG(seed, imgs.device)
            with dropout_rng(rng):
                outs = net(preprocess_images(imgs), *[micro[k] for k in MODEL_KEYS],
                           gt_bboxes=micro["gt_bboxes"],
                           gt_labels=micro["gt_labels"], gt_mask=micro["gt_mask"],
                           dn=_to(draws["dn"], micro))
        with tracing.span("train.loss"):
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
        with tracing.span("train.step", step=optimizer.count):
            return _train_step(batch, generator, draws, depth_weight)

    def _train_step(batch, generator, draws, depth_weight):
        model.train()
        world = distributed.world()
        micros = split_microbatches(batch, accum_steps)
        if draws is None:
            with tracing.span("train.draws"):
                draws = [make_draws(model, m, generator, world=world,
                                    rank=distributed.rank()) for m in micros]
        counts = [batch["gt_mask"].sum().float()]
        if "gt_depth" in batch:
            counts.append(depth_fg_count(batch["gt_depth"], **depth_kw).float())
        counts = distributed.all_reduce_sum(torch.stack(counts))
        pos_norm = counts[0].clamp(min=1.0) / accum_steps
        fg_norm = (counts[1].clamp(min=1.0) / accum_steps
                   if "gt_depth" in batch else None)
        optimizer.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        aux: Dict[str, List[np.ndarray]] = {}
        for i, (micro, d) in enumerate(zip(micros, draws)):
            sync = ddp is None or i == len(micros) - 1
            with contextlib.nullcontext() if sync else ddp.no_sync():
                losses = loss_fn(micro, d, depth_weight, pos_norm, fg_norm)
                with tracing.span("train.backward"):
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
        if world > 1:
            keys = sorted(metrics)
            total = distributed.all_reduce_sum(
                torch.stack([metrics[k].float() for k in keys]))
            metrics = dict(zip(keys, total.unbind()))
        # undo the interleave: microbatch a, row p was sample p * A + a
        for k, parts in aux.items():
            stacked = np.stack(parts, axis=2)  # [L, B / A, A, G]
            metrics[k] = stacked.reshape(stacked.shape[0], -1,
                                         *stacked.shape[3:])
        with tracing.span("train.optimizer"):
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



def sum_gradients(state, bucket):
    """`DistributedDataParallel` communication hook: the bucket's gradients
    summed over the ranks (DDP's own hook averages them). Each rank's loss
    is its part of the global loss, so the sum is the global gradient."""
    fut = torch.distributed.all_reduce(bucket.buffer(), async_op=True)
    return fut.get_future().then(lambda f: f.value()[0])
