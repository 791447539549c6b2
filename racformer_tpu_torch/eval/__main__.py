"""Evaluation driver of the port (counterpart of the repository's `val.py`),
on one CUDA device unless `--device cpu` is asked for:

    python -m racformer_tpu_torch.eval \\
        --config racformer_tpu_torch/configs/racformer_r50_nuimg_704x256_f8.py \\
        [--checkpoint FILE] [--synthetic] [--streaming [--streams N]]

Three protocols: the batched offline forward over every frame of each
sample's window (`OfflineEvaluator`, `--batch-size` samples per call), the
single-stream streaming latency protocol (`--streaming`: one frame per step
through the feature cache, reset at scene boundaries) and the multi-stream
throughput protocol (`--streaming --streams N`: N scene streams in
lockstep). The dataset is VoD, synthetic or nuScenes, chosen as `val.py`
chooses. Prints `eval: N samples, X samples/s` and the metrics as JSON;
`--plot-dir DIR` also writes the nuScenes PR / TP curves and the per-class
table there (`tools/eval_plots.render_all`, matplotlib; none for VoD).

Under `torchrun` (`torchrun --nproc_per_node=N -m racformer_tpu_torch.eval
...`; NCCL on CUDA, one card per process, gloo with `--device cpu`) the
offline protocol shards every global batch of N * `--batch-size` samples
over the ranks and the multi-stream protocol its streams (when N divides
their count, else rank 0 runs them all); the single-stream latency protocol
runs on rank 0 alone, without a process group. Where the ranks share the
work every rank gathers all predictions; where rank 0 runs alone the others
return at once with none, so that no rank waits in a collective (and its
timeout) for rank 0's whole run. Rank 0 prints the rate and the metrics and
writes `--dump-eval`.

Checkpoints: a torch `.pth` / `.pt` state dict (the reference's parameter
names, which are the port's; its `version` field sets the legacy box
convention), a pickled `{'params': ..., 'batch_stats': ...}` file with
numpy leaves (converted by `tools.convert_weights.state_dict_from_jax`), or
the port train driver's work dir (its newest checkpoint's weights and
BatchNorm statistics). A JAX work dir of orbax checkpoints, or a pickle of
JAX arrays, is refused: `scripts/jax_checkpoint_to_torch.py` converts it.
Without a checkpoint the model has seeded random weights.

Float32 runs in full float32: `main` turns TF32 off for matmuls and cuDNN
convolutions and prints both flags (`utils.precision`). A nuScenes split is
read with the config's `camera_types`, whose count must be `num_cams`.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import torch

from ..tools.convert_weights import CONVERTER, NumpyOnlyUnpickler
from ..utils import distributed, pin_float32_precision


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--override", nargs="+", default=[])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--streaming", action="store_true",
                   help="per-frame streaming eval with the temporal feature "
                        "cache")
    p.add_argument("--streams", type=int, default=1,
                   help="with --streaming: run N independent scene streams "
                        "in lockstep (the throughput protocol); 1 = the "
                        "single-stream latency protocol")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1,
                   help="samples per offline forward")
    p.add_argument("--plot-dir", default=None,
                   help="write the nuScenes PR / TP curves and the per-class "
                        "table here (tools/eval_plots.py; not for VoD)")
    p.add_argument("--dump-eval", default=None,
                   help="pickle (preds, gts) here for offline re-analysis")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) or cpu, which runs every kernel's "
                        "plain version")
    return p.parse_args(argv)


def camera_types(cfg, model):
    """The nuScenes cameras a config reads: its `camera_types` (the
    front-only configs name three), else the reader's six. A ValueError
    when their count is not the model's `num_cams`. (`val.py` and
    `train.py` pass none, so the JAX package reads six cameras whatever
    the config names.)"""
    from ..data.nuscenes import DEFAULT_CAMERAS

    cams = tuple(cfg.get("camera_types") or DEFAULT_CAMERAS)
    if len(cams) != model.num_cams:
        raise ValueError(f"camera_types names {len(cams)} cameras {list(cams)}"
                         f", but model.num_cams is {model.num_cams}")
    return cams


def build_dataset(cfg, model, synthetic: bool, max_samples=None):
    """The val split: VoD, synthetic or nuScenes, as `val.py` chooses (and
    `train.py` for its in-training eval), capped at `max_samples`."""
    from ..data import NuScenesRadarDataset, SyntheticDataset

    ann = cfg["data"]["val"]["ann_file"]
    is_vod = cfg.get("dataset_type") == "vod"
    if is_vod and os.path.exists(ann) and not synthetic:
        from ..data.vod import VoDDataset

        return VoDDataset(
            ann, data_root=os.path.dirname(os.path.dirname(ann)),
            image_hw=model.image_hw,
            max_radar_points=cfg["radar"]["max_points"],
            max_gt=model.max_gt, max_samples=max_samples)
    if synthetic or not os.path.exists(ann):
        return SyntheticDataset(
            num_samples=max_samples or 8, num_cams=model.num_cams,
            num_frames=model.num_frames, hw=model.image_hw,
            max_radar_points=cfg["radar"]["max_points"],
            max_gt=model.max_gt)
    return NuScenesRadarDataset(
        ann, num_frames=model.num_frames,
        frame_interval=int(cfg["data"]["val"].get("frame_interval", 6)),
        camera_types=camera_types(cfg, model), image_hw=model.image_hw,
        ida_cfg=dict(cfg["ida_aug"]) if cfg.get("ida_aug") else None,
        max_radar_points=cfg["radar"]["max_points"], max_gt=model.max_gt,
        training=False, max_samples=max_samples)


def load_checkpoint(model, path: str, legacy_version: str) -> str:
    """Load `path` into `model`; returns the legacy box-convention version
    it names (`legacy_version` when it names none)."""
    if os.path.isdir(path):
        from ..train.checkpoint import CheckpointManager, checkpoint_steps

        if not checkpoint_steps(path):
            raise SystemExit(f"{path} holds no checkpoint of the port's train "
                             f"driver (a JAX work_dir of orbax checkpoints "
                             f"needs JAX: convert it with {CONVERTER})")
        step = CheckpointManager(path, verify=False).restore_latest_eval(model)
        print(f"restored step {step} from {path}")
        return legacy_version
    if path.endswith((".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        model.load_state_dict(ckpt.get("state_dict", ckpt))
        return ckpt.get("version", legacy_version) or legacy_version
    from ..tools.convert_weights import state_dict_from_jax

    with open(path, "rb") as f:
        variables = NumpyOnlyUnpickler(f).load()
    legacy_version = variables.pop("version", legacy_version)
    model.load_state_dict(state_dict_from_jax(variables, model))
    return legacy_version


def main(argv=None):
    """Runs the evaluation; returns (preds, metrics) for callers in
    process (metrics is None without ground truth)."""
    args = parse_args(argv)
    pin_float32_precision()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the eval driver needs a CUDA device (pass --device "
                         "cpu to run the plain versions on the CPU)")
    launched = all(k in os.environ for k in distributed.ENV)
    if launched and args.streaming and args.streams <= 1:
        # the latency protocol runs on one card: rank 0 alone, joining no
        # process group, and the other ranks leave at once
        rank = (distributed.rank() if torch.distributed.is_initialized()
                else int(os.environ["RANK"]))
        if rank != 0:
            print(f"rank {rank}: the single-stream protocol runs on rank 0")
            return [], None
        launched = False
    owned = launched and not torch.distributed.is_initialized()
    device = (distributed.init(args.device) if launched
              else torch.device(args.device))
    try:
        return _evaluate(args, device)
    finally:
        if owned:
            distributed.shutdown()


def _evaluate(args, device):
    from ..config import Config
    from ..model import RaCFormer, config_kwargs, random_init_
    from .offline import OfflineEvaluator, detection_metrics
    from .streaming import (StreamingEvaluator, run_multistream,
                            run_single_stream)

    rank = distributed.rank()
    cfg = Config.fromfile(args.config).merge_override(args.override)
    with torch.device(device):
        model = RaCFormer(**config_kwargs(cfg))
    random_init_(model, torch.Generator().manual_seed(0))
    legacy_version = "v1.0.0"
    if args.checkpoint:
        legacy_version = load_checkpoint(model, args.checkpoint,
                                         legacy_version)
    model.eval()
    dataset = build_dataset(cfg, model, args.synthetic,
                            args.max_samples or cfg.get("max_samples"))
    is_vod = cfg.get("dataset_type") == "vod"

    ecfg = dict(cfg.get("eval_cfg", {}))
    ecfg.setdefault("legacy_version", legacy_version)
    num = len(dataset)
    if args.streaming and args.streams > 1:
        ev = StreamingEvaluator(model, eval_cfg=ecfg)
        preds, gts, fps = run_multistream(ev, dataset, args.streams)
    elif args.streaming:  # rank 0 alone (see `main`)
        preds, gts, fps = run_single_stream(
            StreamingEvaluator(model, eval_cfg=ecfg), dataset)
    else:
        ev = OfflineEvaluator(model, eval_cfg=ecfg,
                              batch_size=max(1, int(args.batch_size)))
        preds, gts, fps = ev.run(dataset)
    if rank == 0:
        print(f"eval: {num} samples, {fps:.2f} samples/s")

    metrics = None
    if gts:
        metrics = detection_metrics(
            preds, gts, is_vod=is_vod,
            class_names=list(cfg.get("class_names", [])) or None,
            front_only=bool(cfg.get("eval_front_only", False)),
            return_curves=bool(args.plot_dir))
        if rank == 0:
            if args.plot_dir and not is_vod:
                # the metrics call indexes labels into the protocol's
                # CLASS_NAMES, so the plots do too
                from ..tools.eval_plots import render_all

                render_all(metrics, args.plot_dir)
                print(f"eval plots -> {args.plot_dir}")
            if args.dump_eval:
                with open(args.dump_eval, "wb") as f:
                    pickle.dump((preds, gts), f)
            print(json.dumps({k: round(float(v), 4)
                              for k, v in metrics.items()
                              if isinstance(v, (int, float))}, indent=2))
    return preds, metrics


if __name__ == "__main__":
    main()
