"""The port's spans (`racformer_tpu_torch/utils/tracing.py`): off, they cost
no torch call and record nothing; with the recorder on, the streaming step
and the train step open their named spans nested under one root with one
step id; under `torch.profiler` they land in the trace as `racformer.*`
events and add no `aten::` op; and the benchmark's four readers of them
(`h100_bench/metrics/`) read the numbers their docstrings name."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from h100_bench import harness
from racformer_tpu_torch.data import SyntheticDataset
from racformer_tpu_torch.eval import StreamingEvaluator
from racformer_tpu_torch.eval.streaming import FIELDS, prepare_frame
from racformer_tpu_torch.model import RaCFormer, random_init_
from racformer_tpu_torch.train import Optimizer, make_train_step
from racformer_tpu_torch.utils import tracing

TINY = dict(num_cams=2, num_frames=2, embed_dims=64, num_query=12,
            num_clusters=2, image_hw=(64, 128), depth_bins=16,
            bev_size=(32, 32), max_gt=8, num_decoder_layers=2,
            trunk_dtype=torch.float32)
EVAL_CHILDREN = ["eval.upload", "eval.encode_frame", "eval.window",
                 "eval.decode_window", "eval.decode_boxes", "eval.result"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test runner's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def data():
    return SyntheticDataset(num_samples=4, num_cams=2, num_frames=2,
                            hw=(64, 128), max_radar_points=64, max_gt=8)


@pytest.fixture(scope="module")
def model():
    m = RaCFormer(**TINY, decoder={"gather_dtype": torch.float32})
    return random_init_(m, torch.Generator().manual_seed(0)).eval()


def frames(data):
    return [prepare_frame(data[i], 0.5 * i, False) for i in range(len(data))]


class CountingRecordFunction:
    made = 0

    def __init__(self, name):
        CountingRecordFunction.made += 1
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_off_span_is_the_shared_no_op_and_records_nothing(model, data,
                                                          monkeypatch):
    CountingRecordFunction.made = 0
    monkeypatch.setattr(tracing, "record_function", CountingRecordFunction)
    a, b = tracing.span("eval.step", step=1, frames=1), tracing.span("x")
    assert a is b
    with a:
        tracing.count("h2d_bytes", 10)
    counted = []  # the upload's byte count is not even summed
    monkeypatch.setattr(tracing, "count", lambda *a: counted.append(a))
    ev = StreamingEvaluator(model)
    for f in frames(data)[:2]:
        ev.step(f)
    ev.reset()
    ev.step_batch(frames(data)[2:], [True, True])
    assert tracing.records() == [] and counted == []
    assert CountingRecordFunction.made == 0


def tree(recs):
    """{index: (name, parent name, step)} of the records."""
    return {r.index: (r.name, recs[r.parent].name if r.parent >= 0 else None,
                      r.step) for r in recs}


def test_recorder_nests_the_eval_spans_under_one_step(model, data):
    ev = StreamingEvaluator(model)
    fs = frames(data)
    ev.step(fs[0])
    tracing.enable()
    ev.step(fs[1])
    ev.reset()
    ev.step_batch([fs[2], fs[3]], [True, True])
    tracing.disable()
    recs = tracing.records()
    assert [r.index for r in recs] == list(range(len(recs)))
    roots = [r for r in recs if r.parent < 0]
    assert [(r.name, r.step, r.counts["frames"]) for r in roots] == [
        ("eval.step", 2, 1), ("eval.step", 3, 2)]
    for root in roots:
        mine = [r for r in recs if r.step == root.step]
        children = [r.name for r in mine if r.parent == root.index]
        assert children == EVAL_CHILDREN
        names = tree(recs)
        by_name = {r.name: names[r.index][1] for r in mine}
        assert by_name["model.trunk"] == by_name["model.bev"] == "eval.encode_frame"
        assert by_name["model.head"] == "eval.decode_window"
        assert [r.name for r in mine].count("head.iteration") == 2
        assert all(names[r.index][1] == "model.head"
                   for r in mine if r.name == "head.iteration")
        for r in mine:  # each span lies inside its parent
            p = recs[r.parent] if r.parent >= 0 else r
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    up = [r for r in recs if r.name == "eval.upload"]
    one = sum(np.asarray(fs[1][k]).nbytes for k in FIELDS)
    two = sum(np.asarray(fs[i][k]).nbytes for i in (2, 3) for k in FIELDS)
    assert [r.counts["h2d_bytes"] for r in up] == [one, two]


def test_recorder_nests_the_train_spans_under_one_step(data):
    m = RaCFormer(**TINY, decoder={"gather_dtype": torch.float32})
    random_init_(m, torch.Generator().manual_seed(0)).train()
    opt = Optimizer(m.named_parameters(), total_steps=10)
    step = make_train_step(m, opt, {"num_bins": 16}, accum_steps=2)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in data.batch([0, 1]).items()}
    step(batch, generator=torch.Generator().manual_seed(1))
    tracing.enable()
    step(batch, generator=torch.Generator().manual_seed(2))
    tracing.disable()
    recs = tracing.records()
    names = tree(recs)
    assert {s for _, _, s in names.values()} == {1}
    root = recs[0]
    assert (root.name, root.parent) == ("train.step", -1)
    assert [n for n, p, _ in names.values() if p == "train.step"] == [
        "train.draws", "train.forward", "train.loss", "train.backward",
        "train.forward", "train.loss", "train.backward", "train.optimizer"]
    matching = [r for r in recs if r.name == "train.matching"]
    assert [names[r.index][1] for r in matching] == ["train.loss"] * 2
    L = TINY["num_decoder_layers"]
    assert [r.counts["gt_rows"] for r in matching] == [L * 1 * 8] * 2
    assert {names[r.index][1] for r in recs if r.name == "head.iteration"} == {
        "model.head"}
    # the backward's recompute of the checkpointed iterations opens none
    assert sum(r.name == "head.iteration" for r in recs) == 2 * L


def aten_ops(prof):
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


def test_spans_land_in_the_profile_and_add_no_aten_op(model, data, monkeypatch):
    ev = StreamingEvaluator(model)
    fs = frames(data)
    ev.step(fs[0])
    with profile(activities=[ProfilerActivity.CPU]) as traced:
        ev.step(fs[1])
    keys = {e.key for e in traced.key_averages() if e.device_type == DeviceType.CPU}
    assert {"racformer." + n for n in ["eval.step", *EVAL_CHILDREN, "model.trunk",
                                       "model.bev", "model.head",
                                       "head.iteration"]} <= keys
    monkeypatch.setattr(tracing, "span", lambda *a, **k: tracing._OFF)
    with profile(activities=[ProfilerActivity.CPU]) as bare:
        ev.step(fs[2])
    assert not any(e.key.startswith("racformer.") for e in bare.key_averages())
    assert aten_ops(traced) == aten_ops(bare) > 0


def span(name, index, parent, step, start_ms, end_ms, **counts):
    s = tracing.Span(name, step, counts)
    s.index, s.parent = index, parent
    s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    return s


def test_dispatch_and_matching_readers_on_hand_made_spans(monkeypatch):
    """Two untraced steps from t = 10 s: a lockstep step of 2 frames whose
    result copy starts 30 ms in, and one of 1 frame 20 ms in; a step
    before the stretch is left out. Spans join their step by its id."""
    t0 = 10_000.0  # ms
    recs = [span("eval.step", 0, -1, 7, t0 - 100, t0 - 50, frames=1),
            span("eval.result", 1, 0, 7, t0 - 60, t0 - 50),
            span("eval.step", 2, -1, 8, t0 + 1, t0 + 40, frames=2),
            span("eval.upload", 3, 2, 8, t0 + 1, t0 + 2),
            span("eval.result", 4, 2, 8, t0 + 31, t0 + 40),
            span("eval.step", 5, -1, 9, t0 + 50, t0 + 80, frames=1),
            span("eval.result", 6, 5, 9, t0 + 70, t0 + 80)]
    monkeypatch.setattr(tracing, "records", lambda: recs)
    ctx = SimpleNamespace(untraced=[(t0 / 1e3, (t0 + 45) / 1e3),
                                    ((t0 + 45) / 1e3, (t0 + 85) / 1e3)])
    dispatch = harness.metric_module("dispatch_ms.eval")
    assert dispatch.read(ctx) == pytest.approx((30 + 20) / 3)
    assert dispatch.read(SimpleNamespace(untraced=[])) is None
    recs[6].step = 7  # a result of a step before the stretch is not read
    assert dispatch.read(ctx) == pytest.approx(30 / 2)

    # steps 3 (two microbatches) and 4 (no matching) after the stretch;
    # step 2's matching is left out though it ends inside the window
    recs[:] = [span("train.step", 0, -1, 2, t0 - 40, t0 + 2),
               span("train.matching", 1, 0, 2, t0 - 30, t0 + 1),
               span("train.step", 2, -1, 3, t0 + 3, t0 + 44),
               span("train.matching", 3, 2, 3, t0 + 5, t0 + 12),
               span("train.matching", 4, 2, 3, t0 + 20, t0 + 23),
               span("train.step", 5, -1, 4, t0 + 46, t0 + 84)]
    matching = harness.metric_module("matching_ms.train")
    assert matching.read(ctx) == pytest.approx((7 + 3) / 2)
    recs[:] = []
    assert matching.read(ctx) is None
    # prepare turns the recorder on and hands back what turns it off
    monkeypatch.undo()
    off = dispatch.prepare(ctx)
    assert tracing.recording() and off is tracing.disable
    off()
    assert not tracing.recording()


def test_device_span_readers_on_a_hand_made_trace():
    """The span's host event's linked device total, per served frame; the
    span's device-side annotation of the same name is not read."""
    def avg(key, device_type, us):
        return SimpleNamespace(key=key, device_type=device_type,
                               device_time_total=us)

    trace = SimpleNamespace(units=2, averages=[
        avg("racformer.eval.encode_frame", DeviceType.CPU, 12_000.0),
        avg("racformer.eval.encode_frame", DeviceType.CUDA, 99_000.0),
        avg("racformer.eval.decode_window", DeviceType.CPU, 40_000.0),
        avg("aten::mm", DeviceType.CPU, 5_000.0)])
    ctx = SimpleNamespace(trace=trace, frames_per_step=4)
    assert harness.metric_module("encode_ms.eval").read(ctx) == pytest.approx(1.5)
    assert harness.metric_module("decode_ms.eval").read(ctx) == pytest.approx(5.0)
    # a program without the spans, or a trace without device time: nothing
    trace.averages = [avg("racformer.eval.encode_frame", DeviceType.CPU, 0.0)]
    assert harness.metric_module("encode_ms.eval").read(ctx) is None
    assert harness.metric_module("decode_ms.eval").read(ctx) is None


def test_a_traced_tiny_cell_reports_the_span_metrics(monkeypatch):
    """The harness runs the readers' `prepare` and `read` around a traced
    run of the tiny stream cell on the CPU: the recorder reads the host's
    dispatch ms, and the profiler, with no device, gives no device ms."""
    from h100_bench.tests import tiny

    tiny.tiny_mixes(monkeypatch)
    r = tiny.run("flagship.stream", trace=True, seconds=1.0)
    assert r["correct"]
    assert r["metrics"]["dispatch_ms.eval"]["value"] > 0
    assert "encode_ms.eval" not in r["metrics"]
    assert "decode_ms.eval" not in r["metrics"]
    assert not tracing.recording()
