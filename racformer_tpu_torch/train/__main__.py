"""Training driver of the port (counterpart of the repository's `train.py`),
on one CUDA device:

    python -m racformer_tpu_torch.train \\
        --config racformer_tpu/configs/racformer_r50_nuimg_704x256_f8.py \\
        --synthetic --max-steps 5

Seeded random weights, the config's model, optimizer, batch size per device
and accumulation steps, batches from the port's `SyntheticDataset`.
Prints one JSON line of metrics per step. Checkpoints, hooks, EMA,
in-training eval, real datasets and several devices are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import Config
from ..data import SyntheticDataset
from ..model import RaCFormer, random_init_
from .optim import Optimizer
from .step import make_train_step

MODEL_FIELDS = ("num_cams", "num_frames", "embed_dims", "num_query",
                "num_clusters", "num_levels", "num_groups", "image_hw",
                "pc_range", "depth_bins", "bev_size", "query_denoising",
                "max_gt")


def build(cfg, device, seed: int, total_steps: int):
    """(model, optimizer, train_step, dataset, batch size) of a config (a
    dict of the config file's names): the model with seeded random weights
    in train mode on `device`."""
    mcfg = dict(cfg["model"])
    kwargs = {k: mcfg[k] for k in MODEL_FIELDS if k in mcfg}
    kwargs["num_classes"] = len(cfg["class_names"])
    decoder = dict(cfg.get("decoder") or {})
    with torch.device(device):
        model = RaCFormer(**kwargs, decoder=decoder)
    random_init_(model, torch.Generator().manual_seed(seed)).train()
    opt = dict(cfg.get("optimizer", {}))
    optimizer = Optimizer(
        model.named_parameters(), base_lr=opt.get("base_lr", 4e-4),
        weight_decay=opt.get("weight_decay", 0.01), total_steps=total_steps,
        warmup_steps=opt.get("warmup_steps", 500),
        clip_norm=opt.get("clip_norm", 35.0))
    batch = int(cfg.get("batch_size_per_chip", 2))
    accum = int(cfg.get("accumulate_steps", 1))
    if batch % accum:
        raise ValueError(f"accumulate_steps={accum} does not divide "
                         f"batch_size_per_chip={batch}")
    step = make_train_step(model, optimizer, dict(cfg.get("depth", {})), accum)
    dataset = SyntheticDataset(
        num_samples=max(64, batch * 4), num_cams=model.num_cams,
        num_frames=model.num_frames, hw=model.image_hw,
        max_radar_points=cfg["radar"]["max_points"], max_gt=model.max_gt,
        seed=seed)
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
    total = args.max_steps or 100_000
    model, optimizer, train_step, dataset, batch = build(
        cfg, device, args.seed, total)
    gen = torch.Generator().manual_seed(args.seed + 17)
    steps_per_epoch = max(len(dataset) // batch, 1)
    for step in range(total):
        first = (step % steps_per_epoch) * batch
        sample = to_device(dataset.batch(list(range(first, first + batch))),
                           device)
        t0 = time.perf_counter()
        metrics = train_step(sample, gen)
        torch.cuda.synchronize(device)
        line = {"step": step + 1, "lr": optimizer.lr(step=step),
                "step_ms": (time.perf_counter() - t0) * 1e3}
        line.update({k: float(v) for k, v in metrics.items()})
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
