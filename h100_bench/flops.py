"""Matmul and convolution FLOPs of a cell's unit of work, counted with
`torch.utils.flop_counter.FlopCounterMode` on the plain reference at the
configuration's shapes, so the count is the same whatever implements it.

    python3 -m h100_bench.flops <config> [train]   # on a CUDA card

The counts go into the configuration's file under `flops`, with this
command; `metrics/step_mfu.*.py` read them. `eval_frame` is one frame's
encode plus one window's decode, `train_step` one train step.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import harness
from .reference.streaming import WindowReference
from .traffic import generator


def count_eval(cfg: dict, device) -> int:
    mix = generator.load_mix("stream")
    pool = generator.frame_pool(cfg, dict(mix, pool_frames=1), 0)
    model = harness.build_reference(cfg, harness.reference_state(cfg, 0, device),
                                    device).requires_grad_(False)
    T = model.num_frames
    tape = [(0, True, 0.0)] + [(0, False, 0.5 * j) for j in range(1, T)]
    ref = WindowReference(model, pool, [tape], {}, device)
    for k in range(T - 1):  # the history, outside the count (and a warm-up)
        ref.encode(k)
    with FlopCounterMode(display=False) as counter:
        ref.window(T - 1)  # the newest frame's encode and the window's decode
    return int(counter.get_total_flops())


def count_train(cfg: dict, device) -> int:
    """One train step (its microbatches' forward and backward, AdamW), the
    decoder's per-iteration checkpointing off so that no recompute counts."""
    from .reference.train.optim import Optimizer
    from .reference.train.step import make_train_step

    mix = generator.load_mix("train")
    batch = harness.to_device(generator.train_pool(cfg, dict(mix, pool_batches=1), 0)[0],
                              device)
    model = harness.build_reference(cfg, harness.reference_state(cfg, 0, device),
                                    device).train()
    model.pts_bbox_head.transformer.decoder.remat = False
    opt = Optimizer(model.named_parameters(), **harness.optimizer_kwargs(cfg, mix))
    step = make_train_step(model, opt, dict(cfg.get("depth", {})),
                           int(mix["microbatches"]))
    step(batch, generator=torch.Generator().manual_seed(0))  # warm
    with FlopCounterMode(display=False) as counter:
        step(batch, generator=torch.Generator().manual_seed(1))
    return int(counter.get_total_flops())


def main(argv):
    name = argv[0]
    bench = harness.load_benchmark()
    cfg = harness.load_config(bench, name)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    out = {"config": name, "device": device, "eval_frame": count_eval(cfg, device)}
    if "train" in argv[1:]:
        harness.free()
        out["train_step"] = count_train(cfg, device)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
