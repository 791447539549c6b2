"""The port's train driver (`racformer_tpu_torch/train/__main__.py`) makes
the run-level decisions of the repository's `train.py`: the total steps of
the schedule and the run, each epoch's batch order, the depth-loss weight
curriculum, the accumulation steps clamped to the batch, the synthetic
dataset's size and its seed. The copies of `hostdata` and `hooks` equal
their originals; `train.py`'s own lines are checked to still say what the
port copies."""

import math
import pathlib
import runpy

import numpy as np
import pytest
import torch

from racformer_tpu.data import SyntheticDataset as JaxSyntheticDataset
from racformer_tpu.train import hooks as jhooks
from racformer_tpu.train import hostdata as jhostdata

from racformer_tpu_torch.train import __main__ as driver
from racformer_tpu_torch.train import hooks, hostdata

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "racformer_tpu" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
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


def test_main_runs_the_schedule(monkeypatch, capsys):
    """main() on a stand-in step: 577 steps of 32-step epochs (64 samples,
    batch 2), each with its epoch's batch and the curriculum's weight."""
    calls = []

    class Dataset:
        def __len__(self):
            return 64

        def batch(self, idx):
            return {"idx": np.asarray(idx)}

    class Opt:
        def lr(self, step):
            return 0.0

    def step(sample, gen, depth_weight):
        calls.append((sample["idx"].tolist(), depth_weight))
        return {"loss_total": torch.tensor(1.0)}

    monkeypatch.setattr(driver, "build", lambda cfg, dev, seed, max_steps: (
        None, Opt(), step, Dataset(), 2))
    monkeypatch.setattr(driver, "to_device", lambda sample, dev: sample)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    driver.main(["--config", str(CONFIG), "--synthetic", "--max-steps", "577",
                 "--seed", "4"])
    assert len(calls) == 577 and capsys.readouterr().out.count("\n") == 577
    for s, (idx, weight) in enumerate(calls):
        order = jhostdata.epoch_order(4, s // 32, 64)
        assert idx == jhostdata.host_batch_indices(order, s % 32, 2, 1, 0)
        assert weight == jhooks.DepthWeightCurriculum(18).weight(s // 32)
    assert calls[575][1] == 2.0 and calls[576][1] == 1.0
