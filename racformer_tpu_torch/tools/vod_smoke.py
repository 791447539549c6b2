"""VoD training smoke of the port, the counterpart of
`docs/experiments/vod_smoke.py`: a training run on a learnable VoD fixture
whose loss must fall, with KITTI mAP before and after.

Builds a LEARNABLE KITTI-format VoD fixture on disk (the original's, copied):
GT boxes whose radar points sit ON the boxes (so the radar->BEV branch
carries localization signal) and whose images carry bright rendered
rectangles at the projected box locations (camera signal). Then it drives
the port's drivers in process, in the original's order, at its tiny model
shapes and schedule (240 steps, warmup 20, lr 4e-4): the train driver for
one step and the eval driver on that untrained checkpoint, then the train
driver for the whole schedule (`dataset_type=vod` -> `VoDDataset` ->
collate -> the loop -> the in-training KITTI eval) and the eval driver on
its checkpoint.

The fixture draws from a FIXED pool of 6 scene layouts (48 train samples)
and evaluates on 8 samples drawn from the same pool: a capacity and
pipeline smoke (can the loss fall and mAP rise through the whole VoD
pipeline?), not a generalization claim. The original trained on 8 CPU
devices of 1 sample each; one device here takes the same global batch of
8 (`batch_size_per_chip=8`), so the schedule is the same 6 steps an epoch.

    python -m racformer_tpu_torch.tools.vod_smoke [workdir] [--device cuda|cpu]
        [--epochs N] [--plain]

on the card unless `--device cpu`; `--epochs` (default 40) shortens the
schedule; `--plain` routes the card's tensors through the kernels' plain
versions (`gather_kernel.force_reference()`). Writes
`<workdir>/VOD_SMOKE.json` with the original's fields (its losses from the
log's lines, every 50th step) and prints a summary over every step's
metrics (the train driver's summary keeps them all); a non-finite
grad_norm at any step fails it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pickle
import tempfile

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "racformer_vod.py")
EPOCHS = 40

H, W = 64, 128
P2 = np.array([[50, 0, 64, 0], [0, 50, 32, 0], [0, 0, 1, 0]], float)


def render_scene(rng, n_box):
    """One scene: boxes in the camera frame (KITTI: x right, y down,
    z forward), radar points on the boxes, image with bright rectangles."""
    loc = np.stack([
        rng.uniform(-6, 6, n_box),          # x
        np.full(n_box, 1.5),                # y (ground)
        rng.uniform(6, 25, n_box),          # z
    ], axis=1).astype(np.float32)
    cls = rng.integers(0, 3, n_box)
    dims_by_cls = np.array([[4.0, 1.6, 1.9], [0.7, 1.8, 0.7],
                            [1.8, 1.7, 0.6]], np.float32)  # l, h, w
    dims = dims_by_cls[cls] * rng.uniform(0.9, 1.1, (n_box, 3)).astype(
        np.float32)
    rot = rng.uniform(-0.4, 0.4, n_box).astype(np.float32)

    # radar: 6 points per box, jittered inside the box footprint + clutter
    pts = []
    for b in range(n_box):
        p = np.zeros((6, 7), np.float32)
        p[:, 0] = loc[b, 0] + rng.uniform(-0.4, 0.4, 6) * dims[b, 0]
        p[:, 1] = loc[b, 1] - rng.uniform(0.0, 0.8, 6) * dims[b, 1]
        p[:, 2] = loc[b, 2] + rng.uniform(-0.4, 0.4, 6) * dims[b, 2]
        p[:, 3] = 15.0 + 5.0 * cls[b] + rng.normal(0, 1, 6)  # RCS by class
        pts.append(p)
    clutter = np.zeros((8, 7), np.float32)
    clutter[:, 0] = rng.uniform(-10, 10, 8)
    clutter[:, 1] = rng.uniform(0.5, 2.0, 8)
    clutter[:, 2] = rng.uniform(4, 30, 8)
    clutter[:, 3] = rng.uniform(-5, 5, 8)
    pts.append(clutter)
    radar = np.concatenate(pts)

    # image: bright class-colored rectangle at each projected box
    img = rng.integers(20, 60, (H, W, 3)).astype(np.uint8)
    for b in np.argsort(-loc[:, 2]):  # far to near
        uvw = P2[:3, :3] @ loc[b] + P2[:3, 3]
        u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
        half_w = 0.5 * dims[b, 0] * 50 / loc[b, 2]
        half_h = 0.5 * dims[b, 1] * 50 / loc[b, 2]
        u0, u1 = int(u - half_w), int(u + half_w) + 1
        v0, v1 = int(v - 2 * half_h), int(v) + 1
        u0, u1 = max(u0, 0), min(u1, W)
        v0, v1 = max(v0, 0), min(v1, H)
        if u1 > u0 and v1 > v0:
            color = np.zeros(3, np.uint8)
            color[cls[b]] = 230
            img[v0:v1, u0:u1] = color
    return loc, dims, rot, cls, radar, img


def build_fixture(root, n_train=48, n_pool=6, seed=0):
    os.makedirs(root, exist_ok=True)
    names = np.array(["Car", "Pedestrian", "Cyclist"])
    pool = [render_scene(np.random.default_rng(seed + 17 * s),
                         int(np.random.default_rng(seed + s).integers(2, 5)))
            for s in range(n_pool)]
    infos = []
    for i in range(n_train):
        loc, dims, rot, cls, radar, img = pool[i % n_pool]
        rp = os.path.join(root, f"r{i}.bin")
        radar.tofile(rp)
        ip = os.path.join(root, f"i{i}.png")
        from PIL import Image
        Image.fromarray(img).save(ip)
        infos.append(dict(
            image=dict(image_idx=i, image_path=ip),
            calib=dict(P2=P2, Tr_velo_to_cam=np.eye(4), R0_rect=np.eye(4)),
            radar_path=rp,
            annos=dict(name=names[cls], location=loc, dimensions=dims,
                       rotation_y=rot),
        ))
    pkl = os.path.join(root, "vod_infos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(infos, f)
    return pkl


def tiny_overrides(pkl: str, epochs: int = EPOCHS):
    """The original's tiny model and schedule, the batch of its 8 devices
    on one."""
    return [
        "model.embed_dims=64", "model.num_query=24", "model.num_clusters=2",
        "model.image_hw=(64,128)", "model.depth_bins=16",
        "model.bev_size=(32,32)", "model.max_gt=8", "radar.max_points=64",
        "batch_size_per_chip=8", "depth.num_bins=16",
        f"data.train.ann_file='{pkl}'", f"data.val.ann_file='{pkl}'",
        "optimizer.warmup_steps=20", "optimizer.base_lr=4e-4",
        f"total_epochs={epochs}", f"evaluation.interval={epochs}",
        "evaluation.max_samples=8", "accumulate_steps=1",
    ]


def _quiet(main, argv):
    """A driver's main(argv) in process, its printing swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def run(workdir=None, device: str = "cuda", epochs: int = EPOCHS):
    """The smoke; returns (the VOD_SMOKE.json record, the training run's
    metrics at every step, {run name: the train driver's summary, or the
    eval driver's (predictions, metrics)})."""
    from ..eval.__main__ import main as eval_main
    from ..train.__main__ import main as train_main

    wd = workdir or tempfile.mkdtemp(prefix="vod_smoke_")
    os.makedirs(wd, exist_ok=True)
    pkl = build_fixture(os.path.join(wd, "data"))
    tiny = tiny_overrides(pkl, epochs)
    base = ["--config", CONFIG, "--device", device]
    evaluate = lambda ckpt: base + ["--max-samples", "8", "--checkpoint", ckpt,
                                    "--override", *tiny]

    # a step-1 "untrained" checkpoint for the baseline mAP
    wd0, wd1 = os.path.join(wd, "wd0"), os.path.join(wd, "wd1")
    runs = {}
    runs["train0"] = _quiet(train_main, base + [
        "--max-steps", "1", "--work-dir", wd0, "--override", *tiny])
    runs["eval0"] = _quiet(eval_main, evaluate(wd0))
    # the smoke train run (40 epochs x 48 samples / batch 8 = 240 steps)
    runs["train1"] = _quiet(train_main, base + [
        "--work-dir", wd1, "--override", *tiny])
    runs["eval1"] = _quiet(eval_main, evaluate(wd1))

    logged, in_training_eval = [], []
    with open(os.path.join(wd1, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("phase") == "val":
                in_training_eval.append(rec)
            elif "loss_total" in rec:
                logged.append(rec)
    losses = [r["loss_total"] for r in logged]

    def grab(metrics):
        return {k: (None if metrics is None or k not in metrics
                    else float(metrics[k]))
                for k in ("mAP3D_all", "mAP3D_corridor")}

    res = dict(
        losses_first5=losses[:5], losses_last5=losses[-5:],
        n_loss_lines=len(losses), in_training_eval=in_training_eval,
        untrained=grab(runs["eval0"][1]), trained=grab(runs["eval1"][1]),
    )
    with open(os.path.join(wd, "VOD_SMOKE.json"), "w") as f:
        json.dump(res, f, indent=2)
    return res, runs["train1"]["metrics"], runs


def fifths(records):
    """(mean of the first fifth, mean of the last fifth) of the steps'
    loss_total."""
    losses = [r["loss_total"] for r in records]
    k = max(1, len(losses) // 5)
    return float(np.mean(losses[:k])), float(np.mean(losses[-k:]))


def nonfinite_steps(records):
    """The steps whose grad_norm is not finite. The losses cannot
    show it: they are nan_to_num'd as the JAX package's are, so a model
    gone non-finite logs a loss of 0."""
    return [r["step"] for r in records if not np.isfinite(r["grad_norm"])]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--plain", action="store_true",
                   help="run the kernels' plain versions on the card")
    args = p.parse_args(argv)
    import torch

    from ..ops import gather_kernel

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the VoD smoke runs on a CUDA device (pass --device "
                         "cpu to run the plain versions on the CPU)")
    with (gather_kernel.force_reference() if args.plain
          else contextlib.nullcontext()):
        res, records, runs = run(args.workdir, args.device, args.epochs)
    print(json.dumps(res, indent=2))
    if records:
        a, b = fifths(records)
        norms = [r["grad_norm"] for r in records]
        print(f"loss first-fifth mean {a:.3f} -> last-fifth mean {b:.3f}; "
              f"{len(records)} steps, largest finite grad_norm "
              f"{max([g for g in norms if np.isfinite(g)], default=None)}")
    print("workdir:", os.path.dirname(runs["train1"]["work_dir"]))
    bad = nonfinite_steps(records)
    if bad:
        raise SystemExit(f"the training went non-finite: grad_norm at the "
                         f"steps {bad}")
    return res


if __name__ == "__main__":
    main()
