"""Training and evaluation over several ranks: the port's
`--distributed` path against its one-process path, on the CPU with gloo
over 2 worker processes (`tests/torch_distributed_workers.py`) at tiny
configs.

* A 2-rank train step (global batch 4, 2 rows per rank, 2 microbatches,
  explicit draws, dropout off, f32) against the one-process step on the
  same 4 rows: losses 1e-5 relative, gradients 1e-4 of each tensor's max
  or 4 times their measured rounding spread (see the test), the BatchNorm
  running statistics 1e-5, equal on both ranks (the one-process step is
  held against the JAX package's in tests/test_torch_train_step.py).
* The synced `BatchNorm` (both variance forms) against flax `nn.BatchNorm`
  in train mode on the concatenated global batch: outputs, running
  statistics and the input gradient 1e-5.
* The normalizers: each rank's losses get the global batch's positive
  count over the accumulation steps.
* The microbatch-union rule: the ranks' microbatch a, in rank order, is the
  global batch's microbatch a.
* The eval driver's offline protocol (5 samples: a padded tail), its
  4-stream protocol (2 streams per rank), 3 streams (rank 0 runs them all)
  and its single-stream protocol (rank 0) on 2 ranks against one process:
  equal predictions on every rank that shares the work and in rank 0's
  `--dump-eval` (1e-5: the same per-sample computation, streams in batches
  of 2 instead of 4); where rank 0 runs alone, rank 1 returns at once with
  none, and rank 0's run may outlast the process group's timeout.
* The train driver on 2 ranks for 2 steps and a --resume to step 4: the
  logs, checkpoints and best checkpoint written once, by rank 0; match
  statistics per rank; every rank's restored digest the saved one.

Each test starts its workers with the spawn method, gives them a file store
under its own tmp_path (no port is shared between tests run in parallel), a
process-group timeout of 90 s (8 s where the test is about that timeout),
and joins them within 120 s.
"""

import json
import multiprocessing
import os
import pathlib
import pickle
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu_torch.train.step import split_microbatches

from tests import torch_distributed_workers as workers
from tests.test_drivers import TINY

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "racformer_tpu_torch" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
JOIN_S = 120


def spawn(fn, tmp_path, *args, world=2, timeout_s=90):
    """fn(rank, world, *args) on `world` gloo ranks (a process-group
    timeout of `timeout_s`); returns their results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    out.mkdir()
    store = f"file://{out / 'store'}"
    procs = [ctx.Process(target=workers.run,
                         args=(fn, r, world, store, str(out), args,
                               timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errors = {r: (out / f"err_{r}.txt").read_text()
              for r in range(world) if (out / f"err_{r}.txt").exists()}
    assert not alive, f"ranks still running after {JOIN_S} s; errors: {errors}"
    assert all(p.exitcode == 0 for p in procs), errors
    return [torch.load(out / f"out_{r}.pt", weights_only=False)
            for r in range(world)]


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


SEED = 6


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The train step on 2 ranks: global batch 4, 2 rows per rank, 2
    microbatches."""
    return spawn(workers.train_step, tmp_path_factory.mktemp("step"), 4, 2,
                 2, SEED)


def one_process_steps(scales):
    """The one-process step on the whole global batch, with its images
    scaled by each of `scales` (1: unchanged)."""
    batch = workers.global_batch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = []
    try:
        for scale in scales:
            workers.global_batch = lambda seed, B, s=scale: {
                **batch(seed, B), "imgs": batch(seed, B)["imgs"] * s}
            out.append(workers.train_step(0, 1, 4, 4, 2, SEED))
    finally:
        workers.global_batch = batch
        torch.set_num_threads(threads)
    return out


def test_train_step_on_two_ranks_equals_one_process(two_ranks):
    """Losses 1e-5 relative; BatchNorm running statistics 1e-5, bitwise
    equal on both ranks. Each gradient to 1e-4 of its tensor's max, or,
    where it is larger, to 4 times the rounding spread of the one-process
    step: the most that the gradient moves when the images are scaled by
    1 +- 2^-22. On this config a change of that size (train-mode
    BatchNorm over 2 samples of 4x8 feature maps, the DepthNet's ASPP
    pooling over 4 values) moves 206 of the 357 gradient tensors by
    1e-3 to 3e-2 of their max, and the 2-rank step's own rounding (the
    statistics summed per rank, the gradients summed over the ranks) by
    up to 2 times that spread; a missing all-reduce in BatchNorm's
    backward moves them by up to 8e5 times it."""
    one, up, down = one_process_steps([1.0, 1 + 2**-22, 1 - 2**-22])
    for r, got in enumerate(two_ranks):
        for k, v in one["metrics"].items():
            assert rel(got["metrics"][k], v) <= 1e-5, (r, k, got["metrics"][k], v)
        for n, g in one["grads"].items():
            spread = max(float((p["grads"][n] - g).abs().max())
                         for p in (up, down))
            err = float((got["grads"][n] - g).abs().max())
            assert err <= max(1e-4 * float(g.abs().max()), 4 * spread), (
                r, n, err, spread)
        for n, b in one["buffers"].items():
            if b.is_floating_point():
                np.testing.assert_allclose(got["buffers"][n], b, rtol=1e-5,
                                           atol=1e-5, err_msg=n)
            torch.testing.assert_close(got["buffers"][n],
                                       two_ranks[0]["buffers"][n], rtol=0,
                                       atol=0)
        # the optimizer saw the same summed gradients on every rank
        for n, p in got["params"].items():
            assert torch.equal(p, two_ranks[0]["params"][n]), n


def test_normalizers_cover_the_global_batch(two_ranks):
    """Each microbatch's set losses are normalized by the global batch's
    positive count over the accumulation steps, on every rank."""
    mask = workers.global_batch(SEED + 1, 4)["gt_mask"]
    want = max(float(mask.sum()), 1.0) / 2
    local = [float(mask[2 * r:2 * r + 2].sum()) for r in range(2)]
    assert local[0] != local[1]  # the ranks' own counts differ
    for got in two_ranks:
        assert got["pos_norms"] == [want, want]


@pytest.mark.parametrize("fast_variance", [True, False],
                         ids=["fast_variance", "two_pass"])
def test_synced_batchnorm_equals_flax_on_the_global_batch(fast_variance,
                                                          tmp_path):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 5, 6, 16)) * rng.uniform(0.5, 3, 16)
         + rng.normal(size=16)).astype(np.float32)
    ranks = spawn(workers.batchnorm, tmp_path, torch.from_numpy(x),
                  fast_variance)
    C = x.shape[-1]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, use_fast_variance=fast_variance)
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, C),
                            "bias": jnp.linspace(-0.2, 0.2, C)},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    w = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)

    def loss(xj):
        y, upd = bn.apply(variables, xj, mutable=["batch_stats"])
        return (y * w).sum(), (y, upd["batch_stats"])

    (_, (y, stats)), dx = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x))
    np.testing.assert_allclose(torch.cat([r["y"] for r in ranks]),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([r["dx"] for r in ranks]),
                               np.asarray(dx), rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], np.asarray(stats["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["var"], np.asarray(stats["var"]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bpc, accum, world", [(2, 2, 2), (4, 2, 2),
                                               (4, 4, 2), (2, 1, 4),
                                               (6, 3, 4)])
def test_microbatch_union_is_the_global_microbatch(bpc, accum, world):
    """Rank r holds global rows [r * bpc, (r + 1) * bpc) (hostdata's
    layout). With bpc a multiple of the accumulation steps, the ranks'
    microbatch a, concatenated in rank order, is the global batch's
    microbatch a: the rows each BatchNorm of microbatch a normalizes over
    are JAX's."""
    rows = {"imgs": torch.arange(bpc * world)}
    want = split_microbatches(rows, accum)
    for a in range(accum):
        union = torch.cat([
            split_microbatches({"imgs": rows["imgs"][r * bpc:(r + 1) * bpc]},
                               accum)[a]["imgs"] for r in range(world)])
        assert union.tolist() == want[a]["imgs"].tolist()


EVAL = ["--config", str(CONFIG), "--device", "cpu", "--synthetic",
        "--override", *TINY, "decoder.num_layers=2"]


@pytest.mark.parametrize("protocol", [
    ["--max-samples", "5"],
    ["--max-samples", "8", "--streaming", "--streams", "4"],
    ["--max-samples", "6", "--streaming", "--streams", "3"],
    ["--max-samples", "3", "--streaming"]],
    ids=["offline", "streams4", "streams3_on_rank0", "single_stream"])
def test_eval_driver_on_two_ranks_equals_one_process(protocol, tmp_path):
    """The offline protocol with a padded tail (5 samples, 2 per global
    batch), 4 streams (2 per rank), 3 streams (not a multiple of the
    world: rank 0 runs all) and the single-stream protocol (rank 0). Where
    the ranks share the work every rank returns all predictions; where
    rank 0 runs alone rank 1 returns none."""
    from racformer_tpu_torch.eval.__main__ import main as eval_main

    dump = tmp_path / "dump.pkl"
    ranks = spawn(workers.driver, tmp_path, "racformer_tpu_torch.eval.__main__",
                  EVAL + ["--dump-eval", str(dump)] + protocol)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, _ = eval_main(EVAL + protocol)
    finally:
        torch.set_num_threads(threads)
    with open(dump, "rb") as f:  # written by rank 0
        dumped, _ = pickle.load(f)
    alone = protocol[-1] in ("--streaming", "3")  # rank 0 runs alone
    assert (ranks[1]["preds"] == []) == alone
    for got in (ranks[:1] if alone else ranks) + [{"preds": dumped}]:
        assert len(got["preds"]) == len(want)
        for p, q in zip(got["preds"], want):
            for k in q:
                np.testing.assert_allclose(p[k], q[k], rtol=1e-5, atol=1e-5,
                                           err_msg=k)


@pytest.mark.parametrize("protocol", [
    ["--max-samples", "6", "--streaming", "--streams", "3"],
    ["--max-samples", "3", "--streaming"]],
    ids=["streams3_on_rank0", "single_stream"])
def test_eval_driver_rank0_alone_outlasts_the_timeout(protocol, tmp_path):
    """Where rank 0 runs the protocol alone, its run may take longer than
    the process group's timeout (a nuScenes val set at the single-stream
    rate takes ~12 min against NCCL's 10): rank 0's first step is held 12
    s under a timeout of 8 s, and both ranks still finish, rank 0 with
    every prediction and the metrics."""
    ranks = spawn(workers.slow_driver, tmp_path,
                  "racformer_tpu_torch.eval.__main__", EVAL + protocol, 12.0,
                  timeout_s=8)
    n = int(protocol[1])
    assert len(ranks[0]["preds"]) == n and ranks[0]["metrics"] is not None
    assert ranks[1] == {"preds": [], "metrics": None}


RUN = TINY + ["decoder.num_layers=2", "optimizer.warmup_steps=1",
              "synthetic_samples=4", "evaluation.interval=1",
              "evaluation.max_samples=2", "log_interval=1", "data_workers=1"]


def test_train_driver_on_two_ranks_writes_once_and_resumes(tmp_path):
    """2 ranks, global batch 2 (1 per rank), 2 steps per epoch: run A
    --max-steps 2, run B --resume to 4, each with an in-training eval per
    epoch sharded over the ranks."""
    wd = tmp_path / "wd"
    mod = "racformer_tpu_torch.train.__main__"
    base = ["--config", str(CONFIG), "--device", "cpu", "--synthetic",
            "--distributed", "--work-dir", str(wd), "--match-stats"]
    a = spawn(workers.driver, tmp_path, mod,
              base + ["--max-steps", "2", "--override", *RUN])
    b = spawn(workers.driver, tmp_path, mod,
              base + ["--max-steps", "4", "--resume", "--override", *RUN])
    for run in (a, b):
        assert [r["world"] for r in run] == [2, 2]
        assert [r["global_batch"] for r in run] == [2, 2]
        assert len(run[0]["saves"]) == 1 and run[1]["saves"] == []
        assert run[0]["saves"][0]["verified"]
        assert [len(r["evals"]) for r in run] == [1, 1]
        assert [e["samples"] for r in run for e in r["evals"]] == [2, 2]
        assert run[0]["evals"][0]["metrics"] == run[1]["evals"][0]["metrics"]
    assert [r["start_step"] for r in b] == [2, 2]
    assert [r["restored_digest"] for r in b] == [a[0]["digest"]] * 2
    records = [json.loads(line) for line in
               (wd / "metrics.jsonl").read_text().splitlines()]
    # MetricLogger's every-50-steps records, once each: rank 1 writes none
    assert [r["step"] for r in records if "phase" not in r] == [0]
    assert [r["step"] for r in records if r.get("phase") == "val"] == [2, 4]
    assert sorted(os.listdir(wd / "checkpoints")) == ["2", "4"]
    assert (wd / "best" / "metrics.json").is_file()
    for rank in range(2):
        for epoch in range(2):
            assert (wd / "match_stats" / "dec_0" / f"rank_{rank}"
                    / f"match_epoch{epoch}.json").is_file()
    assert all(r["bn_syncs"] > 0 for r in a + b)
