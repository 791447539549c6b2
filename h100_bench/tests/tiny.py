"""A tiny cut of the benchmark's configurations and mixes, for CPU tests:
2 cameras, 2 frames, 64 channels, 12 queries, 64x128 images."""

from __future__ import annotations

import copy
import json
import time

from h100_bench import harness
from h100_bench.traffic import generator

TINY_MODEL = dict(num_cams=2, num_frames=2, embed_dims=64, num_query=12,
                  num_clusters=2, image_hw=[64, 128], depth_bins=16,
                  bev_size=[16, 16], max_gt=8)
TINY_MIX = dict(pool_frames=6, scene_frames=[4, 5], radar_points=[16, 64],
                check_frames=8, pool_batches=3)
# the port and the reference agree to rounding on the CPU (a batch of 4
# streams to 2.6e-4 in a logit)
LIMITS = {"stream": {"score_gap": 1e-3, "box_gap": 1e-3, "rank_gap": 1e-3},
          "train": {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4,
                    "loss_gap_window_steps": 1e-5, "change_gap_window": 1e-4}}
SEED = 2**31 + 12345


def tiny_cfg(name="flagship"):
    cfg = copy.deepcopy(harness.load_config(harness.load_benchmark(), name))
    cfg["model"].update(TINY_MODEL)
    cfg["decoder"].update(num_layers=2)
    cfg["radar"]["max_points"] = 64
    cfg["rig"]["camera_yaw_deg"] = [0.0, 180.0]
    cfg["depth"]["num_bins"] = 16
    return cfg


def tiny_mixes(monkeypatch):
    """Shrink every mix the harness loads."""
    load = generator.load_mix
    monkeypatch.setattr(generator, "load_mix",
                        lambda name: dict(load(name), **TINY_MIX))


def with_train_cell(bench):
    """The benchmark with the train cell, whether or not it is listed."""
    bench = copy.deepcopy(bench)
    if not any(w["name"] == "flagship.train" for w in bench["workloads"]):
        bench["workloads"].append({"name": "flagship.train", "config": "flagship",
                                   "traffic": "train", "chips": 1, "why": "test"})
    return bench


def traffic(cell):
    return harness.find_cell(with_train_cell(harness.load_benchmark()), cell)["traffic"]


def run(cell, trace=False, seconds=2.0, **kw):
    """One tiny CPU run of `cell` (the harness's look for a chip skipped).
    Two seconds hold a few scenes even while the process is still warming
    up, so the sampled frames are not all scene starts."""
    kind = generator.load_mix(traffic(cell))["kind"]
    kw.setdefault("limits", LIMITS["train" if kind == "train" else "stream"])
    bench = with_train_cell(harness.load_benchmark())
    name = harness.find_cell(bench, cell)["config"]
    return harness.run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                            bench=bench, cfg=tiny_cfg(name), **kw)


def dumps(result):
    return json.dumps(result)
