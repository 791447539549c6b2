"""The port's train driver (`racformer_tpu_torch/train/__main__.py`) makes
the run-level decisions of the repository's `train.py`: the total steps of
the schedule and the run, each epoch's batch order, the depth-loss weight
curriculum, the accumulation steps clamped to the batch, the synthetic
dataset's size and its seed, the nuScenes training set's arguments. The
copies of `hostdata` and `hooks` equal their originals; `train.py`'s own
lines are checked to still say what the port copies.

End to end on the CPU (`--device cpu`, the tiny overrides of
`tests/test_drivers.py`, 2 decoder layers, 2 steps per epoch): a run of 2
steps and a resumed run to step 4, with the EMA, the match statistics,
`--load-from` and the in-training eval at every epoch; the eval driver on
the work dir; one step on a fabricated nuScenes split; the refusals
(`--distributed` without torchrun's environment, an unknown remat
policy, no CUDA device).
"""

import contextlib
import io
import json
import math
import os
import pathlib
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from racformer_tpu.data import SyntheticDataset as JaxSyntheticDataset
from racformer_tpu.train import hooks as jhooks
from racformer_tpu.train import hostdata as jhostdata

from racformer_tpu_torch.data import nuscenes as port_nuscenes
from racformer_tpu_torch.eval import __main__ as eval_driver
from racformer_tpu_torch.train import Optimizer
from racformer_tpu_torch.train import __main__ as driver
from racformer_tpu_torch.train import hooks, hostdata
from racformer_tpu_torch.utils import logging as port_logging

from tests.test_drivers import TINY
from tests.test_torch_data import nuscenes_fixture

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "racformer_tpu_torch" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
TRAIN_PY = (REPO / "train.py").read_text()


@pytest.mark.parametrize("line", [
    "total_steps = args.max_steps or steps_per_epoch * total_epochs",
    "steps_per_epoch = max(len(dataset) // global_batch, 1)",
    'num_samples=int(cfg.get("synthetic_samples",',
    "eff = math.gcd(accum, batch_per_chip)",
    "curriculum = DepthWeightCurriculum(start_epoch=18)",
    "jnp.asarray(curriculum.weight(epoch), jnp.float32)",
    "_orders[epoch] = epoch_order(args.seed, epoch, len(dataset))",
    "return host_batch_indices(_orders[epoch], step % steps_per_epoch,",
])
def test_train_py_still_says_what_the_port_copies(line):
    assert line in TRAIN_PY


@pytest.mark.parametrize("n, batch, epochs, max_steps", [
    (64, 2, 36, None), (65, 2, 36, None), (3, 4, 36, None), (64, 2, 36, 10)])
def test_schedule_equals_train_py(n, batch, epochs, max_steps):
    steps_per_epoch = max(n // batch, 1)
    assert driver.schedule(n, batch, epochs, max_steps) == (
        steps_per_epoch, max_steps or steps_per_epoch * epochs)


def test_epoch_batches_equal_original():
    """Every step's batch for three 32-step epochs of 64 samples: a fresh
    permutation each epoch, drawn as train.py draws it."""
    indices = driver.batch_indices(seed=3, steps_per_epoch=32,
                                   num_samples=64, batch=2)
    seen = []
    for step in range(96):
        order = jhostdata.epoch_order(3, step // 32, 64)
        want = jhostdata.host_batch_indices(order, step % 32, 2, 1, 0)
        assert indices(step) == want
        seen.append(want)
    for epoch in range(3):
        assert sorted(sum(seen[32 * epoch: 32 * epoch + 32], [])) == list(
            range(64))
    assert seen[:32] != seen[32:64]
    for seed, epoch, n in ((0, 0, 7), (5, 9, 64)):
        np.testing.assert_array_equal(hostdata.epoch_order(seed, epoch, n),
                                      jhostdata.epoch_order(seed, epoch, n))
    order = jhostdata.epoch_order(1, 2, 10)
    for p in range(2):
        assert (hostdata.host_batch_indices(order, 7, 4, 2, p)
                == jhostdata.host_batch_indices(order, 7, 4, 2, p))
    with pytest.raises(ValueError):
        hostdata.host_batch_indices(order, 0, 3, 2, 0)


def test_depth_weight_curriculum_equals_original():
    port, jax_ = hooks.DepthWeightCurriculum(18), jhooks.DepthWeightCurriculum(18)
    for epoch in range(40):
        assert port.weight(epoch) == jax_.weight(epoch)
    # 32-step epochs: step 575 is the last of epoch 17, step 576 the first of 18
    assert port.weight(575 // 32) == 2.0 and port.weight(576 // 32) == 1.0


@pytest.mark.parametrize("accum, batch, want", [
    (2, 2, 2), (2, 1, 1), (3, 4, 1), (4, 6, 2), (1, 3, 1)])
def test_accumulation_clamped_as_train_py(accum, batch, want, capsys):
    assert driver.accumulation_steps(accum, batch) == want == math.gcd(
        accum, batch)
    out = capsys.readouterr().out
    assert ("does not divide" in out) == bool(batch % accum)
    with pytest.raises(ValueError):
        driver.accumulation_steps(0, 2)


def tiny_config(**extra):
    cfg = runpy.run_path(str(CONFIG))
    cfg["model"] = dict(cfg["model"], num_cams=1, num_frames=2,
                        image_hw=(32, 64), max_gt=4)
    cfg["radar"] = dict(cfg["radar"], max_points=16)
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("extra, n", [({}, 64), ({"synthetic_samples": 40}, 40),
                                      ({"batch_size_per_chip": 20}, 80)])
def test_synthetic_dataset_size_and_seed_as_train_py(extra, n):
    """`synthetic_samples` honoured (default max(64, 4 batches)), and the
    dataset at seed 0 whatever the run's seed: its samples equal those of
    the dataset train.py builds."""
    cfg = tiny_config(**extra)

    class Model:
        num_cams, num_frames, image_hw, max_gt = 1, 2, (32, 64), 4

    ds = driver.synthetic_dataset(cfg, Model, int(cfg["batch_size_per_chip"]))
    want = JaxSyntheticDataset(num_samples=n, num_cams=1, num_frames=2,
                               hw=(32, 64), max_radar_points=16, max_gt=4)
    assert len(ds) == n and ds.seed == 0
    for k, v in want[n - 1].items():
        np.testing.assert_array_equal(ds[n - 1][k], v, err_msg=k)


def test_main_runs_the_schedule(monkeypatch, tmp_path):
    """main() on a stand-in step: 577 steps of 32-step epochs (64 samples,
    batch 2), each with its epoch's batch and the curriculum's weight, read
    through the prefetching loader; the metrics reach the logger in blocks
    of `log_interval` (10) steps and at each epoch's end, never one step at
    a time, and a checkpoint is written at each epoch's end and the last
    step."""
    calls, logged = [], []

    class Dataset:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return {"idx": np.asarray(i)}

    def step(sample, gen, depth_weight):
        calls.append((sample["idx"].tolist(), depth_weight))
        return {"loss_total": torch.tensor(1.0)}

    def build(cfg, dev, seed, max_steps, **kw):
        model = torch.nn.Linear(2, 2)
        return (model, Optimizer(model.named_parameters(), total_steps=577),
                step, Dataset(), 2)

    monkeypatch.setattr(driver, "build", build)
    monkeypatch.setattr(driver, "to_device", lambda sample, dev: sample)
    monkeypatch.setattr(port_logging.MetricLogger, "log_step",
                        lambda self, s, m, lr=None: logged.append(
                            (s, len(calls))))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    result = driver.main([
        "--config", str(CONFIG), "--synthetic", "--max-steps", "577",
        "--seed", "4", "--device", "cpu", "--work-dir", str(tmp_path),
        "--override", "evaluation.interval=0"])
    assert len(calls) == 577 and result["last_step"] == 577
    for s, (idx, weight) in enumerate(calls):
        order = jhostdata.epoch_order(4, s // 32, 64)
        assert idx == jhostdata.host_batch_indices(order, s % 32, 2, 1, 0)
        assert weight == jhooks.DepthWeightCurriculum(18).weight(s // 32)
    assert calls[575][1] == 2.0 and calls[576][1] == 1.0
    flushed, pending = [], 0
    for s in range(577):
        pending += 1
        if pending >= 10 or (s + 1) % 32 == 0 or s == 576:
            flushed += [(k, s + 1) for k in range(s + 1 - pending, s + 1)]
            pending = 0
    assert logged == flushed
    assert [r["step"] for r in result["saves"]] == list(range(32, 577, 32)) + [577]
    assert [b["steps"] for b in result["blocks"]][:4] == [10, 10, 10, 2]


# --- end to end on the CPU --------------------------------------------------

RUN = TINY + ["decoder.num_layers=2", "optimizer.warmup_steps=1",
              "synthetic_samples=2", "evaluation.interval=1",
              "evaluation.max_samples=2", "log_interval=2", "data_workers=2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 2 steps (epoch 0) with --ema, --match-stats and --load-from;
    run B: --resume to step 4 (epoch 1). The logger's calls are recorded
    against the number of train steps made when each came."""
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("train")
    wd = tmp / "wd"
    pre = tmp / "pre.pkl"
    with open(pre, "wb") as f:  # an mmdet-named stem conv
        pickle.dump({"backbone.conv1.weight": np.random.default_rng(0).normal(
            size=(64, 3, 7, 7)).astype("float32")}, f)
    steps, logged, out = [0], [], {}
    make_train_step = driver.make_train_step

    def counting(*a, **k):
        step = make_train_step(*a, **k)

        def run(*b, **c):
            steps[0] += 1
            return step(*b, **c)

        return run

    try:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(driver, "make_train_step", counting)
        log_step = port_logging.MetricLogger.log_step
        mp.setattr(port_logging.MetricLogger, "log_step",
                   lambda self, s, *a, **k: (logged.append((s, steps[0])),
                                             log_step(self, s, *a, **k)))
        base = ["--config", str(CONFIG), "--device", "cpu", "--synthetic",
                "--work-dir", str(wd), "--ema", "--match-stats"]
        for name, extra in (("a", ["--max-steps", "2", "--load-from",
                                   str(pre)]),
                            ("b", ["--max-steps", "4", "--resume"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out[name] = driver.main(base + extra + ["--override", *RUN])
            out[name + "_stdout"] = buf.getvalue()
        yield wd, out, logged
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def test_run_writes_checkpoints_evals_and_match_stats(runs):
    wd, out, _ = runs
    a, b = out["a"], out["b"]
    assert [s["step"] for s in a["saves"]] == [2]
    assert [s["step"] for s in b["saves"]] == [4]
    assert all(s["verified"] for s in a["saves"] + b["saves"])
    assert sorted(os.listdir(wd / "checkpoints")) == ["2", "4"]
    records = [json.loads(line) for line in
               (wd / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if r.get("phase") == "val"]
    assert [r["step"] for r in val] == [2, 4] and "NDS" in val[0]
    assert [r for r in records if "phase" not in r]  # train records
    best = json.loads((wd / "best" / "metrics.json").read_text())
    assert best["step"] in (2, 4) and "NDS" in best
    assert os.listdir(wd / "best" / "checkpoints") == [str(best["step"])]
    for layer in range(2):
        for epoch in range(2):
            assert (wd / "match_stats" / f"dec_{layer}" / "rank_0"
                    / f"match_epoch{epoch}.json").is_file()
    assert "[convert_weights] 1 tensors loaded" in out["a_stdout"]
    assert (wd / "config_dump.py").is_file()
    assert (wd / "backup" / "train" / "__main__.py").is_file()
    assert (wd / "backup" / "csrc" / "patch_scatter.cu").is_file()
    assert [e["samples"] for e in a["evals"] + b["evals"]] == [2, 2]


def test_summary_keeps_every_step_metrics(runs):
    """The driver's summary holds each step's scalar metrics, where the log
    (every 50th step, as train.py's) holds step 0 alone."""
    wd, out, _ = runs
    for run, steps in (("a", [0, 1]), ("b", [2, 3])):
        got = out[run]["metrics"]
        assert [m["step"] for m in got] == steps
        assert all(np.isfinite(m["loss_total"]) and np.isfinite(m["grad_norm"])
                   for m in got)
    logged = [json.loads(line)["step"] for line in
              (wd / "metrics.jsonl").read_text().splitlines()
              if "loss_total" in line and '"phase"' not in line]
    assert logged == [0]


def test_resume_restores_the_saved_state_bitwise(runs):
    _, out, _ = runs
    assert "resumed from step 2" in out["b_stdout"]
    assert out["b"]["start_step"] == 2 and out["b"]["last_step"] == 4
    assert out["b"]["restored_digest"] == out["a"]["digest"]
    assert out["a"]["restored_digest"] is None


def test_metrics_reach_the_logger_in_blocks(runs):
    """log_interval=2: each step's metrics are logged only once its block
    of 2 steps has run, never after each step."""
    _, _, logged = runs
    assert [s for s, _ in logged] == [0, 1, 2, 3]
    assert [n for _, n in logged] == [2, 2, 4, 4]


def test_eval_leaves_the_model_training_and_its_statistics(runs):
    """After the in-training eval (which ran after the step-4 save) the
    model is back in train mode with the decoder's checkpointing on, and
    its state, BatchNorm statistics included, is the one saved."""
    wd, out, _ = runs
    model = out["b"]["model"]
    assert all(m.training for m in model.modules())
    assert model.pts_bbox_head.transformer.decoder.remat
    saved = torch.load(wd / "checkpoints" / "4" / "state.pth",
                       weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(saved[k], v), k


def test_eval_driver_reads_the_work_dir(runs):
    """`python -m racformer_tpu_torch.eval --checkpoint <work_dir>` gives
    the predictions the in-memory model gave in its last in-training eval
    (the same weights, the same synthetic samples)."""
    wd, out, _ = runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        preds, metrics = eval_driver.main([
            "--config", str(CONFIG), "--device", "cpu", "--synthetic",
            "--max-samples", "2", "--checkpoint", str(wd), "--override",
            *TINY, "decoder.num_layers=2"])
    finally:
        torch.set_num_threads(threads)
    want = out["b"]["eval_preds"]
    assert len(preds) == len(want) == 2 and "NDS" in metrics
    for p, w in zip(preds, want):
        for k in w:
            np.testing.assert_array_equal(p[k], w[k], err_msg=k)


def six_camera_split(tmp_path):
    """`tests/test_torch_data.py`'s nuScenes fixture with its two cameras
    repeated under the six names the reader asks for by default."""
    pkl, src = nuscenes_fixture(tmp_path, np.random.default_rng(3))
    with open(pkl, "rb") as f:
        infos = pickle.load(f)["infos"]
    for info in infos:
        for rec in [info] + info["sweeps_cam"]:
            cams = list(rec["cams"].values())
            rec["cams"] = {name: cams[i % 2] for i, name in
                           enumerate(port_nuscenes.DEFAULT_CAMERAS)}
    with open(pkl, "wb") as f:
        pickle.dump({"infos": infos}, f)
    return pkl, src


@pytest.mark.parametrize("line", [
    'frame_interval=tuple(cfg.data["train"].get("frame_interval", (4, 8))),',
    "ida_cfg=dict(cfg.ida_aug) if cfg.get(\"ida_aug\") else None,",
    "bev_aug_cfg=dict(cfg.bev_aug) if cfg.get(\"bev_aug\") else None,",
    "training=True,",
    "seed=args.seed,",
])
def test_train_py_builds_the_nuscenes_set_so(line):
    assert line in TRAIN_PY


def test_nuscenes_training_set_as_train_py(tmp_path, monkeypatch):
    """On a fabricated nuScenes split the driver builds the training set
    with train.py's arguments and trains a step on it."""
    pkl, (h, w) = six_camera_split(tmp_path)
    seen = []

    class Spy(port_nuscenes.NuScenesRadarDataset):
        def __init__(self, ann, **kw):
            seen.append((ann, kw))
            super().__init__(ann, **kw)

    monkeypatch.setattr("racformer_tpu_torch.data.NuScenesRadarDataset", Spy)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    over = [*TINY, "model.num_cams=6", "decoder.num_layers=2",
            f"data.train.ann_file={pkl}", f"ida_aug.src_dim=({h},{w})",
            "ida_aug.final_dim=(64,128)", "ida_aug.resize_lim=(0.45,0.55)",
            "evaluation.interval=0", "data_workers=2"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = driver.main(["--config", str(CONFIG), "--device", "cpu",
                              "--max-steps", "1", "--seed", "3", "--work-dir",
                              str(tmp_path / "wd"), "--override", *over])
    finally:
        torch.set_num_threads(threads)
    cfg = driver.Config.fromfile(str(CONFIG)).merge_override(over)
    assert seen == [(pkl, dict(
        num_frames=2, frame_interval=(4, 8),
        camera_types=port_nuscenes.DEFAULT_CAMERAS, image_hw=(64, 128),
        ida_cfg=dict(cfg["ida_aug"]), bev_aug_cfg=dict(cfg["bev_aug"]),
        max_radar_points=64, max_gt=8, training=True, seed=3))]
    assert result["last_step"] == 1
    rec = json.loads((tmp_path / "wd" / "metrics.jsonl").read_text()
                     .splitlines()[0])
    assert np.isfinite(rec["loss_total"]) and "loss_depth" in rec


@pytest.mark.parametrize("extra, match", [
    (["--distributed"], "torchrun"),
    (["--override", "decoder.remat_policy=nope"],
     "unknown decoder remat_policy 'nope'"),
    ([], "CUDA")])
def test_refusals(extra, match, monkeypatch, tmp_path):
    """--distributed without torchrun's environment, an unknown remat
    policy, and no CUDA device without --device cpu."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device = [] if match == "CUDA" else ["--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        driver.main(["--config", str(CONFIG), "--synthetic", "--work-dir",
                     str(tmp_path), *device, *extra])
