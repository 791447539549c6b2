"""Worker processes of `tests/test_torch_distributed.py`: each joins a gloo
process group through a file store, runs one function of this module on its
rank and saves the result where the test reads it. No JAX here: a worker
imports only the port.
"""

import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# f32 throughout: a bf16 trunk rounds a relative change of 1e-7 up to 4e-3
KW = dict(num_cams=2, num_frames=2, embed_dims=64, num_query=12,
          num_clusters=2, image_hw=(64, 128), depth_bins=16,
          bev_size=(32, 32), num_decoder_layers=2, max_gt=4,
          trunk_dtype=torch.float32, decoder={"gather_dtype": torch.float32})
DEPTH = dict(d_lo=1.0, d_hi=65.0, num_bins=16, downsample=16)
G = 4


def run(fn, rank, world, store, out_dir, args, timeout_s=90):
    """The body of worker `rank`: fn(rank, world, *args) under a gloo
    process group on `store` with a timeout of `timeout_s`, its result
    saved to out_dir/out_<rank>.pt (the traceback to out_dir/err_<rank>.txt
    on failure)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def global_batch(seed, B):
    """A seeded batch of B samples for the model of `KW`: cameras on a ring
    looking outwards, images of coarse random colour blocks under 30%
    noise (train-mode BatchNorm on pure noise magnifies rounding noise,
    see tests/test_torch_train_step.py), boxes around the car, sparse
    depth targets."""
    rng = np.random.default_rng(seed)
    T, N, H, W, P = 2, 2, 64, 128, 64
    l2i = np.broadcast_to(np.eye(4, dtype=np.float32), (B, T, N, 4, 4)).copy()
    for n in range(N):
        yaw = 2 * np.pi * n / N
        R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1],
                      [np.cos(yaw), np.sin(yaw), 0]], np.float32)
        K = np.array([[W / 2, 0, W / 2], [0, W / 2, H / 2], [0, 0, 1]],
                     np.float32)
        l2i[:, :, n, :3, :3] = K @ R
    blocks = rng.uniform(0, 255, (B, T, N, 2, 4, 3))
    imgs = (0.7 * blocks.repeat(32, axis=3).repeat(32, axis=4)
            + 0.3 * rng.uniform(0, 255, (B, T, N, H, W, 3)))
    imgs *= rng.uniform(0.1, 1.0, (B, T, N, 1, 1, 1))
    boxes = np.zeros((B, G, 9), np.float32)
    boxes[..., 0:2] = rng.uniform(-20, 20, (B, G, 2))
    boxes[..., 2] = rng.uniform(-2, 1, (B, G))
    boxes[..., 3:6] = rng.uniform(0.5, 5, (B, G, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    boxes[..., 7:9] = rng.normal(size=(B, G, 2))
    mask = np.arange(G)[None] < rng.integers(1, G + 1, (B, 1))
    boxes[~mask] = 0.0
    batch = dict(
        imgs=imgs.astype(np.float32),
        radar_points=(rng.normal(size=(B, T, P, 7)) * 10).astype(np.float32),
        radar_mask=np.ones((B, T, P), bool),
        radar_depth=rng.uniform(0, 60, (B, T, N, H, W)).astype(np.float32),
        radar_rcs=rng.uniform(-30, 30, (B, T, N, H, W)).astype(np.float32),
        lidar2img=l2i, img2lidar=np.linalg.inv(l2i).astype(np.float32),
        time_diff=np.tile(np.arange(T, dtype=np.float32) * 0.5, (B, 1)),
        gt_bboxes=boxes, gt_mask=mask,
        gt_labels=np.where(mask, rng.integers(0, 10, (B, G)), 0).astype(
            np.int32),
        gt_depth=(rng.uniform(2, 60, (B, N, H, W))
                  * (rng.uniform(size=(B, N, H, W)) < 0.1)).astype(np.float32))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def train_step(rank, world, global_rows, bpc, accum, seed):
    """One train step of the `KW` model (seeded weights, dropout off, no
    clipping, the recipe's AdamW at its first step) on this rank's rows
    [rank * bpc, (rank + 1) * bpc) of the seeded global batch, under
    DistributedDataParallel with the gradients summed (world 1: the
    one-process step on the whole batch). Returns the metrics, the
    gradients, the parameters after the update, the BatchNorm running
    statistics and the normalizers each microbatch's losses were given."""
    from racformer_tpu_torch.model import RaCFormer, random_init_
    from racformer_tpu_torch.train import Optimizer
    from racformer_tpu_torch.train import step as step_mod

    model = random_init_(RaCFormer(**KW), torch.Generator().manual_seed(seed))
    model.train()
    ddp = None
    if dist.is_initialized():
        from torch.nn.parallel import DistributedDataParallel

        ddp = DistributedDataParallel(model, broadcast_buffers=False)
        ddp.register_comm_hook(None, step_mod.sum_gradients)
    opt = Optimizer(model.named_parameters(), clip_norm=1e30)
    norms = []
    detection_loss = step_mod.detection_loss

    def recording(*a, pos_norm=None, **k):
        norms.append(float(pos_norm))
        return detection_loss(*a, pos_norm=pos_norm, **k)

    batch = global_batch(seed + 1, global_rows)
    local = {k: v[rank * bpc:(rank + 1) * bpc] for k, v in batch.items()}
    gen = torch.Generator().manual_seed(seed + 2)
    draws = [step_mod.make_draws(model, m, gen, dropout=False, world=world,
                                 rank=rank)
             for m in step_mod.split_microbatches(local, accum)]
    step = step_mod.make_train_step(model, opt, DEPTH, accum, ddp=ddp)
    step_mod.detection_loss = recording
    try:
        metrics = step(local, draws=draws)
    finally:
        step_mod.detection_loss = detection_loss
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "pos_norms": norms}


def batchnorm(rank, world, x, fast_variance):
    """Train-mode `BatchNorm` on this rank's rows of x, with a backward of
    sum(y * w): the outputs, the running statistics, the input gradient."""
    from racformer_tpu_torch.nn.layers import BatchNorm

    C = x.shape[-1]
    bn = BatchNorm(C, momentum=0.1, fast_variance=fast_variance).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, C))
    rows = x.shape[0] // world
    xr = x[rank * rows:(rank + 1) * rows].clone().requires_grad_(True)
    y = bn(xr)
    w = torch.cos(torch.arange(x.numel(), dtype=torch.float32)).reshape(
        x.shape)[rank * rows:(rank + 1) * rows]
    (y * w).sum().backward()
    return {"y": y.detach(), "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(), "dx": xr.grad.clone()}


def driver(rank, world, module, argv):
    """A driver's main(argv) (`racformer_tpu_torch.train` or `.eval`) on
    this rank; returns what is picklable of its result (the train driver's
    with the BatchNorm all-reduces it made)."""
    import importlib

    from racformer_tpu_torch.nn import layers

    main = importlib.import_module(module).main
    layers.SYNCS = 0
    out = main(argv)
    if module.endswith("train.__main__"):
        return {**{k: v for k, v in out.items() if k not in ("model",)},
                "bn_syncs": layers.SYNCS}
    preds, metrics = out
    return {"preds": preds, "metrics": metrics}


def slow_driver(rank, world, module, argv, sleep_s):
    """`driver` with rank 0's first streaming step held back `sleep_s`
    seconds: rank 0's run outlasts the process group's timeout."""
    from racformer_tpu_torch.eval.streaming import StreamingEvaluator

    step, step_batch = StreamingEvaluator.step, StreamingEvaluator.step_batch
    held = []

    def hold(fn):
        def held_fn(*a, **k):
            if rank == 0 and not held:
                held.append(True)
                time.sleep(sleep_s)
            return fn(*a, **k)
        return held_fn

    StreamingEvaluator.step = hold(step)
    StreamingEvaluator.step_batch = hold(step_batch)
    try:
        return driver(rank, world, module, argv)
    finally:
        StreamingEvaluator.step, StreamingEvaluator.step_batch = (
            step, step_batch)
