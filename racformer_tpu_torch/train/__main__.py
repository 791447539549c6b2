"""Training driver of the port (counterpart of the repository's `train.py`),
on one CUDA device:

    python -m racformer_tpu_torch.train \\
        --config racformer_tpu/configs/racformer_r50_nuimg_704x256_f8.py \\
        --synthetic --max-steps 5

Seeded random weights, the config's model, optimizer, batch size per device
and accumulation steps (clamped to a divisor of the batch), batches of the
port's `SyntheticDataset` drawn from a fresh permutation each epoch, the
depth-loss weight of `DepthWeightCurriculum`, a cosine schedule over
`steps_per_epoch * total_epochs` steps (or `--max-steps`). Prints one JSON
line of metrics per step. Checkpoints, EMA, in-training eval, real datasets
and several devices are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..config import Config
from ..data import SyntheticDataset
from ..model import RaCFormer, config_kwargs, random_init_
from .hooks import DepthWeightCurriculum
from .hostdata import epoch_order, host_batch_indices
from .optim import Optimizer
from .step import make_train_step


def schedule(num_samples: int, batch: int, total_epochs: int,
             max_steps=None):
    """(steps_per_epoch, total_steps) as `train.py` counts them on one
    device: the schedule and the run last `max_steps` or every epoch."""
    steps_per_epoch = max(num_samples // batch, 1)
    return steps_per_epoch, max_steps or steps_per_epoch * total_epochs


def accumulation_steps(accum: int, batch: int) -> int:
    """The config's `accumulate_steps`, clamped to a divisor of the batch
    (gcd) as `train.py` does."""
    if accum < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accum}")
    if batch % accum:
        eff = math.gcd(accum, batch)
        print(f"accumulate_steps={accum} does not divide "
              f"batch_size_per_chip={batch}; using {eff}")
        return eff
    return accum


def batch_indices(seed: int, steps_per_epoch: int, num_samples: int,
                  batch: int):
    """step -> the dataset indices of that step's batch: each epoch a fresh
    permutation of the dataset from (seed, epoch), as `train.py` draws."""
    orders: dict = {}

    def indices(step: int) -> list:
        epoch = step // steps_per_epoch
        if epoch not in orders:
            orders.clear()
            orders[epoch] = epoch_order(seed, epoch, num_samples)
        return host_batch_indices(orders[epoch], step % steps_per_epoch,
                                  batch, 1, 0)

    return indices


def synthetic_dataset(cfg, model: RaCFormer, batch: int) -> SyntheticDataset:
    """The config's synthetic dataset: `synthetic_samples` samples (default
    max(64, 4 batches)) at seed 0, whatever the run's seed, as `train.py`
    builds it."""
    return SyntheticDataset(
        num_samples=int(cfg.get("synthetic_samples", max(64, batch * 4))),
        num_cams=model.num_cams, num_frames=model.num_frames,
        hw=model.image_hw, max_radar_points=cfg["radar"]["max_points"],
        max_gt=model.max_gt)


def build(cfg, device, seed: int, max_steps=None):
    """(model, optimizer, train_step, dataset, batch size) of a config (a
    dict of the config file's names): the model with seeded random weights
    in train mode on `device`, the optimizer's schedule over
    `schedule(...)`'s total steps."""
    with torch.device(device):
        model = RaCFormer(**config_kwargs(cfg))
    random_init_(model, torch.Generator().manual_seed(seed)).train()
    batch = int(cfg.get("batch_size_per_chip", 2))
    accum = accumulation_steps(int(cfg.get("accumulate_steps", 1)), batch)
    dataset = synthetic_dataset(cfg, model, batch)
    _, total_steps = schedule(len(dataset), batch,
                              int(cfg.get("total_epochs", 36)), max_steps)
    opt = dict(cfg.get("optimizer", {}))
    optimizer = Optimizer(
        model.named_parameters(), base_lr=opt.get("base_lr", 4e-4),
        weight_decay=opt.get("weight_decay", 0.01), total_steps=total_steps,
        warmup_steps=opt.get("warmup_steps", 500),
        clip_norm=opt.get("clip_norm", 35.0))
    step = make_train_step(model, optimizer, dict(cfg.get("depth", {})), accum)
    return model, optimizer, step, dataset, batch


def to_device(sample, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in sample.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset (the only one ported)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic training is ported")
    if not torch.cuda.is_available():
        raise SystemExit("the train driver needs a CUDA device")
    cfg = Config.fromfile(args.config)
    device = torch.device("cuda")
    model, optimizer, train_step, dataset, batch = build(
        cfg, device, args.seed, args.max_steps)
    steps_per_epoch, total = schedule(
        len(dataset), batch, int(cfg.get("total_epochs", 36)), args.max_steps)
    indices = batch_indices(args.seed, steps_per_epoch, len(dataset), batch)
    curriculum = DepthWeightCurriculum(start_epoch=18)
    gen = torch.Generator().manual_seed(args.seed + 17)
    for step in range(total):
        sample = to_device(dataset.batch(indices(step)), device)
        t0 = time.perf_counter()
        metrics = train_step(
            sample, gen, depth_weight=curriculum.weight(step // steps_per_epoch))
        torch.cuda.synchronize(device)
        line = {"step": step + 1, "lr": optimizer.lr(step=step),
                "step_ms": (time.perf_counter() - t0) * 1e3}
        line.update({k: float(v) for k, v in metrics.items()})
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
