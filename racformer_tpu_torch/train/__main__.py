"""Training driver of the port (counterpart of the repository's `train.py`),
on one CUDA device unless `--device cpu` is asked for:

    python -m racformer_tpu_torch.train \\
        --config racformer_tpu_torch/configs/racformer_r50_nuimg_704x256_f8.py \\
        [--work-dir DIR] [--override k=v ...] [--resume] [--synthetic] \\
        [--load-from FILE] [--ema] [--match-stats] [--fp16-loss-scale S]
    torchrun --nproc_per_node=N -m racformer_tpu_torch.train --distributed ...

Seeded random weights (or `load_from` / `--load-from`, through
`revise_keys`), the config's model, optimizer, batch size per device and
accumulation steps (clamped to a divisor of the batch), the dataset
`train.py` builds (synthetic, VoD or nuScenes with its augmentation) read
through `PrefetchLoader` in `data_workers` threads, each epoch's batches
from a fresh permutation, the depth-loss weight of `DepthWeightCurriculum`,
a cosine schedule over `steps_per_epoch * total_epochs` steps (or
`--max-steps`).

The metrics stay on the device and are fetched in one block every
`log_interval` steps into `MetricLogger` (`<work_dir>/metrics.jsonl`, every
50th step, as `train.py`'s) and into the returned summary's `metrics`
(every step).
A verified checkpoint is written at every epoch end and at the last step
(`train.checkpoint`, the EMA inside with `--ema`); `--resume` continues from
the newest. Every `evaluation.interval` epochs the current weights (not the
EMA) are evaluated on the val split (`evaluation.mode` offline or
streaming, capped at `evaluation.max_samples`), the metrics logged as
`phase: "val"`, and a new best of `evaluation.save_best` saved under
`<work_dir>/best` (`best_metric`: on VoD mAP3D_all, where `train.py`
keeps the inherited NDS). The random draws come from a generator seeded
with seed + 17 at every start, a resumed run's too, as `train.py`
restarts its key.

`--distributed`, under `torchrun` (`utils.distributed`: NCCL on CUDA, one
card per process, gloo with `--device cpu`): the global batch is
`batch_size_per_chip` times the world, each rank loads its rows of it
(`hostdata.host_batch_indices`), the model runs under
`DistributedDataParallel` with the gradients summed over the ranks
(`step.sum_gradients`), BatchNorm statistics and the losses' normalizers
cover the global batch. Rank 0 alone writes the logs, the checkpoints and
`best/`; every rank restores a `--resume` and the restored digests must
agree. The in-training eval is the offline protocol sharded over the ranks
(`evaluation.mode=streaming` falls back to it, as `train.py` does with
several processes).

Float32 runs in full float32: `main` turns TF32 off for matmuls and cuDNN
convolutions and prints both flags (`utils.precision`). The maps' dtypes
come from the config (`model.trunk_dtype`, `decoder.gather_dtype`:
float32, bfloat16 or float16, each with a kernel instance on the card).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from ..config import Config
from ..data import SyntheticDataset
from ..model import RaCFormer, config_kwargs, random_init_
from ..utils import distributed, pin_float32_precision
from .hooks import DepthWeightCurriculum
from .hostdata import epoch_order, host_batch_indices
from .optim import Optimizer
from .step import make_train_step, sum_gradients

HOST_KEYS = ("token", "scene", "timestamp")  # metadata, not model inputs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--override", nargs="+", default=[])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--load-from", default=None,
                   help="pretrained weights (.pth / .pt or a numpy pickle)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset (no nuScenes needed)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", action="store_true",
                   help="keep an EMA of the weights in the checkpoints")
    p.add_argument("--fp16-loss-scale", type=float, default=None,
                   help="static loss scale (the reference's fp16 = "
                        "dict(loss_scale=512.)); also read from "
                        "cfg.fp16['loss_scale']")
    p.add_argument("--match-stats", action="store_true",
                   help="dump per-decoder-layer Hungarian match statistics "
                        "each epoch")
    p.add_argument("--distributed", action="store_true",
                   help="one process per device under torchrun (DDP)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) or cpu, which runs every kernel's "
                        "plain version")
    return p.parse_args(argv)


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
                  batch: int, world: int = 1, rank: int = 0):
    """step -> the dataset indices of rank `rank`'s rows of that step's
    global batch of `batch` samples: each epoch a fresh permutation of the
    dataset from (seed, epoch), as `train.py` draws. Keeps the current and
    the next epoch's order, so the prefetcher can run ahead across the
    boundary."""
    orders: dict = {}

    def indices(step: int) -> list:
        epoch = step // steps_per_epoch
        if epoch not in orders:
            for e in [k for k in orders if k < epoch - 1]:
                del orders[e]
            orders[epoch] = epoch_order(seed, epoch, num_samples)
        return host_batch_indices(orders[epoch], step % steps_per_epoch,
                                  batch, world, rank)

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


def train_dataset(cfg, model: RaCFormer, batch: int, synthetic: bool,
                  seed: int):
    """The training set `train.py` builds: synthetic when asked for or when
    the config's `data.train.ann_file` is missing, else VoD or nuScenes
    (training=True: random sweep interval, image and BEV augmentation;
    nuScenes reads the config's `camera_types`)."""
    ann = cfg["data"]["train"]["ann_file"]
    if synthetic or not os.path.exists(ann):
        return synthetic_dataset(cfg, model, batch)
    if cfg.get("dataset_type") == "vod":
        from ..data.vod import VoDDataset

        return VoDDataset(
            ann, data_root=cfg["data"]["train"].get("data_root", ""),
            image_hw=model.image_hw,
            max_radar_points=cfg["radar"]["max_points"],
            max_gt=model.max_gt, training=True)
    from ..data import NuScenesRadarDataset
    from ..eval.__main__ import camera_types

    return NuScenesRadarDataset(
        ann, num_frames=model.num_frames,
        frame_interval=tuple(cfg["data"]["train"].get("frame_interval",
                                                      (4, 8))),
        camera_types=camera_types(cfg, model), image_hw=model.image_hw,
        ida_cfg=dict(cfg["ida_aug"]) if cfg.get("ida_aug") else None,
        bev_aug_cfg=dict(cfg["bev_aug"]) if cfg.get("bev_aug") else None,
        max_radar_points=cfg["radar"]["max_points"], max_gt=model.max_gt,
        training=True, seed=seed)


def build(cfg, device, seed: int, max_steps=None, synthetic: bool = True,
          match_stats: bool = False, loss_scale: float = 0.0,
          ddp: bool = False):
    """(model, optimizer, train_step, dataset, batch size per device) of a
    config (a dict of the config file's names): the model with seeded
    random weights in train mode on `device`, the training set
    (`train_dataset`), the optimizer's schedule over `schedule(...)`'s
    total steps at the global batch (the batch per device times the
    world). With `ddp` the step runs the model under
    `DistributedDataParallel`: every parameter gets a gradient in train
    mode (DN included), so `find_unused_parameters` stays off, and the
    BatchNorm statistics are equal on every rank by construction, so the
    buffers are not broadcast before each forward."""
    with torch.device(device):
        model = RaCFormer(**config_kwargs(cfg))
    random_init_(model, torch.Generator().manual_seed(seed)).train()
    batch = int(cfg.get("batch_size_per_chip", 2))
    global_batch = batch * distributed.world()
    accum = accumulation_steps(int(cfg.get("accumulate_steps", 1)), batch)
    dataset = train_dataset(cfg, model, global_batch, synthetic, seed)
    _, total_steps = schedule(len(dataset), global_batch,
                              int(cfg.get("total_epochs", 36)), max_steps)
    opt = dict(cfg.get("optimizer", {}))
    optimizer = Optimizer(
        model.named_parameters(), base_lr=opt.get("base_lr", 4e-4),
        weight_decay=opt.get("weight_decay", 0.01), total_steps=total_steps,
        warmup_steps=opt.get("warmup_steps", 500),
        clip_norm=opt.get("clip_norm", 35.0))
    wrapped = None
    if ddp:
        from torch.nn.parallel import DistributedDataParallel

        wrapped = DistributedDataParallel(
            model, device_ids=[device] if torch.device(device).type == "cuda"
            else None, broadcast_buffers=False, find_unused_parameters=False)
        wrapped.register_comm_hook(None, sum_gradients)
    step = make_train_step(model, optimizer, dict(cfg.get("depth", {})), accum,
                           match_stats=match_stats, loss_scale=loss_scale,
                           ddp=wrapped)
    return model, optimizer, step, dataset, batch


def to_device(sample, device):
    """A collated host batch on `device`, metadata left out; on a CUDA
    device through pinned memory with non-blocking copies on the default
    stream, so the copies are ordered before the step that reads them."""
    pinned = torch.device(device).type == "cuda"
    out = {}
    for k, v in sample.items():
        if k in HOST_KEYS or isinstance(v, list):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if pinned
                  else t.to(device))
    return out


def launch_counts():
    """(K1, K2, K3, K4) launch counters (real kernel launches only)."""
    from ..ops import gather_kernel as gk
    from ..ops import scatter_kernel as sk

    return (gk.LAUNCHES, gk.GATHER_LAUNCHES, sk.LAUNCHES, gk.CORNER_LAUNCHES)


def best_metric(cfg) -> str:
    """The metric that picks `best/`: `evaluation.save_best`, else NDS, or
    mAP3D_all on VoD. A VoD config naming NDS gets mAP3D_all: the VoD
    config inherits `save_best="NDS"` from the nuScenes base it extends,
    and the KITTI metrics have no NDS (`train.py` keeps the name and never
    saves a best checkpoint on VoD)."""
    is_vod = cfg.get("dataset_type") == "vod"
    key = dict(cfg.get("evaluation") or {}).get(
        "save_best", "mAP3D_all" if is_vod else "NDS")
    return "mAP3D_all" if is_vod and key == "NDS" else key


def main(argv=None):
    """Runs the training; returns a summary for callers in process: the
    work dir, the world and global batch, the first and last step, the
    digests of the last save and of a restored state, each step's host
    ms, loader wait and kernel launches, each flush block's synchronized
    ms, each checkpoint save and in-training eval, the model and the last
    eval's predictions."""
    args = parse_args(argv)
    pin_float32_precision()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the train driver needs a CUDA device (pass --device "
                         "cpu to run the plain versions on the CPU)")
    owned = args.distributed and not torch.distributed.is_initialized()
    device = (distributed.init(args.device) if args.distributed
              else torch.device(args.device))
    try:
        return _train(args, device)
    finally:
        if owned:
            distributed.shutdown()


def _train(args, device):
    from ..data.prefetch import PrefetchLoader
    from ..tools.convert_weights import load_pretrained
    from ..utils.logging import MetricLogger, backup_code
    from .checkpoint import CheckpointManager
    from .hooks import MatchStatsHook, ema_init, ema_update

    rank, world = distributed.rank(), distributed.world()
    cfg = Config.fromfile(args.config).merge_override(args.override)
    try:
        config_kwargs(cfg)
    except ValueError as e:
        raise SystemExit(str(e))
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if rank == 0:
        backup_code(work_dir)
        with open(os.path.join(work_dir, "config_dump.py"), "w") as f:
            f.write(cfg.dump())

    match_stats = bool(args.match_stats or cfg.get("match_stats"))
    fp16 = dict(cfg.get("fp16") or {})
    loss_scale = (args.fp16_loss_scale if args.fp16_loss_scale is not None
                  else float(fp16.get("loss_scale", 0.0)))
    model, optimizer, train_step, dataset, batch = build(
        cfg, device, args.seed, args.max_steps, synthetic=args.synthetic,
        match_stats=match_stats, loss_scale=loss_scale, ddp=args.distributed)
    global_batch = batch * world
    steps_per_epoch, total_steps = schedule(
        len(dataset), global_batch, int(cfg.get("total_epochs", 36)),
        args.max_steps)

    path = args.load_from or cfg.get("load_from")
    if path and os.path.exists(path):
        load_pretrained(path, model, cfg.get("revise_keys"))

    ckpt = CheckpointManager(work_dir, max_keep=4)
    ema = ema_init(model) if args.ema else None
    start_step = 0
    if args.resume:
        restored = ckpt.restore_latest(model, optimizer, ema,
                                       map_location=device)
        digests = distributed.all_gather_object(ckpt.restored_digest)
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks restored different states: "
                               f"digests {digests}")
        if restored:
            start_step = restored
            print(f"resumed from step {start_step}")

    match_hook = (MatchStatsHook(os.path.join(work_dir, "match_stats"),
                                 rank=rank) if match_stats else None)
    curriculum = DepthWeightCurriculum(start_epoch=18)
    logger = MetricLogger(work_dir, total_steps=total_steps, rank=rank)
    gen = torch.Generator().manual_seed(args.seed + 17)

    # --- the in-training eval, at true epoch boundaries ------------------
    ev_cfg = dict(cfg.get("evaluation") or {})
    eval_interval = int(ev_cfg.get("interval", 2))
    eval_max = ev_cfg.get("max_samples")
    eval_mode = str(ev_cfg.get("mode", "offline"))
    if eval_mode == "streaming" and world > 1:
        # train.py: a single-controller protocol; several processes fall
        # back to the offline one
        print("evaluation.mode=streaming is a single-process protocol; "
              "multi-process run falls back to offline")
        eval_mode = "offline"
    is_vod = cfg.get("dataset_type") == "vod"
    best_key = best_metric(cfg)
    ev = {"dataset": None, "best": float("-inf"), "last_step": -1,
          "best_mgr": None}
    result = {"work_dir": work_dir, "world": world,
              "global_batch": global_batch, "start_step": start_step,
              "restored_digest": ckpt.restored_digest,
              "steps": [], "metrics": [], "blocks": [], "saves": [],
              "evals": [],
              "model": model, "eval_preds": None}

    def run_eval(step):
        if ev["last_step"] == step:
            return
        ev["last_step"] = step
        from ..eval.__main__ import build_dataset
        from ..eval.offline import OfflineEvaluator, detection_metrics
        from ..eval.streaming import StreamingEvaluator, run_multistream

        if ev["dataset"] is None:
            ev["dataset"] = build_dataset(cfg, model, args.synthetic, eval_max)
        ecfg = dict(cfg.get("eval_cfg", {}))
        k1 = launch_counts()[0]
        t0 = time.perf_counter()
        model.eval()
        try:
            with torch.no_grad():
                if eval_mode == "streaming":
                    preds, gts, _ = run_multistream(
                        StreamingEvaluator(model, eval_cfg=ecfg), ev["dataset"],
                        streams=int(ev_cfg.get("streams", 1)))
                else:
                    preds, gts, _ = OfflineEvaluator(model, eval_cfg=ecfg).run(
                        ev["dataset"], max_samples=eval_max)
        finally:
            model.train()
        result["eval_preds"] = preds
        result["evals"].append({
            "step": step + 1, "samples": len(preds),
            "seconds": time.perf_counter() - t0,
            "k1_launches": launch_counts()[0] - k1})
        if not gts:
            return
        # every rank holds all predictions, so the metrics and the best
        # checkpoint's decision agree on every rank
        metrics = detection_metrics(
            preds, gts, is_vod=is_vod,
            class_names=list(cfg.get("class_names", [])) or None,
            front_only=bool(cfg.get("eval_front_only", False)))
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        logger.log_eval(step + 1, scalars)
        result["evals"][-1]["metrics"] = scalars
        score = scalars.get(best_key)
        if score is not None and score > ev["best"]:
            ev["best"] = score
            if rank == 0:
                if ev["best_mgr"] is None:
                    ev["best_mgr"] = CheckpointManager(
                        os.path.join(work_dir, "best"), max_keep=1,
                        verify=False)
                ev["best_mgr"].save(step + 1, model, optimizer)
                with open(os.path.join(work_dir, "best", "metrics.json"),
                          "w") as f:
                    json.dump({"step": step + 1, best_key: score, **scalars},
                              f)
            distributed.barrier()

    # --- the loop --------------------------------------------------------
    loader = PrefetchLoader(
        dataset, batch_indices(args.seed, steps_per_epoch, len(dataset),
                               global_batch, world, rank),
        total_steps, start_step=start_step,
        num_workers=int(cfg.get("data_workers", 4)), prefetch=2,
        put=lambda b: to_device(b, device))
    log_every = int(cfg.get("log_interval", 10))
    pending = []  # (step, device metrics, device gt refs) fetched in blocks
    block_t0 = [None]

    def flush():
        if not pending:
            return
        keys = [k for k in pending[0][1] if not k.startswith("_")]
        values = torch.stack([torch.stack([m[k].float() for k in keys])
                              for _, m, _ in pending]).cpu().numpy()
        for (s, m, gt), row in zip(pending, values):
            scalars = dict(zip(keys, row.tolist()))
            logger.log_step(s, scalars, lr=optimizer.lr(step=s))
            result["metrics"].append({"step": s, **scalars})
            if match_hook is not None:
                match_hook.record(
                    s, {k: v for k, v in m.items() if k.startswith("_")},
                    *[g.cpu().numpy() for g in gt])
        result["blocks"].append({
            "steps": len(pending),
            "ms": (time.perf_counter() - block_t0[0]) * 1e3})
        pending.clear()
        block_t0[0] = None

    step = start_step
    try:
        for step in range(start_step, total_steps):
            epoch = step // steps_per_epoch
            t0 = time.perf_counter()
            if block_t0[0] is None:
                block_t0[0] = t0
            counts = launch_counts()
            sample = loader.get(step)
            t_got = time.perf_counter()
            metrics = train_step(sample, gen,
                                 depth_weight=curriculum.weight(epoch))
            if ema is not None:
                ema_update(ema, optimizer.params, step)
            result["steps"].append({
                "step": step, "host_ms": (time.perf_counter() - t0) * 1e3,
                "wait_ms": (t_got - t0) * 1e3,
                "launches": [b - a for a, b in zip(counts, launch_counts())]})
            # no per-step host sync: the metrics stay on the device and are
            # fetched in a block every `log_every` steps
            pending.append((step, metrics,
                            (sample["gt_labels"], sample["gt_mask"])
                            if match_hook is not None else None))
            if len(pending) >= log_every or step == total_steps - 1:
                flush()
            if (step + 1) % steps_per_epoch == 0 or step == total_steps - 1:
                flush()
                if match_hook is not None:
                    match_hook.after_epoch(epoch)
                if rank == 0:  # the state is equal on every rank
                    result["saves"].append(ckpt.save(step + 1, model,
                                                     optimizer, ema=ema))
                distributed.barrier()
                # eval fires on true epoch boundaries only; a --max-steps
                # run that stops mid-epoch skips it
                if (eval_interval > 0 and (step + 1) % steps_per_epoch == 0
                        and (epoch + 1) % eval_interval == 0):
                    run_eval(step)
    finally:
        loader.close()
        if match_hook is not None:
            # spill a partial epoch's match statistics rather than drop them
            match_hook.after_epoch(step // steps_per_epoch)
        logger.close()
    result["last_step"] = max(total_steps, start_step)
    result["digest"] = ckpt.last_save["digest"] if ckpt.last_save else None
    print("training done")
    return result


if __name__ == "__main__":
    main()
