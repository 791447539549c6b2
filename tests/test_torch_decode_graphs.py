"""The streaming decoder and encoder replayed as CUDA graphs
(`eval/graphs.py`), at the tiny config of `test_torch_tracing.py`.

On the CPU: the evaluator decodes eagerly and its span counter says so;
only a model whose decoder folds has a replay key; the capture cuts the decode at each K1 call and span (CUDA graphs stood in
for by a stub), drops a cut that captured nothing and leaves the K1 call
sites and the span listener as it found them; a replay copies the window
into the plan's inputs; the pc_range tensors made once leave the head's
outputs as the tensors made per call did. On a card (`cuda` marker):
replayed decodes equal eager ones bit for bit, at B = 1 and at B = 4 with
staggered resets, with K1 launched as often; results handed out stay the
caller's, and the window the evaluator's own after the capture; a capture
of no work leaves no graph; a decode with gradients or in train mode never
replays. The encoder likewise: on the CPU it encodes eagerly and counts
it; only eval mode without gradients on a card has a key, one for each
batch size; its capture cuts at `model.trunk` and `model.bev`; a replay
copies the frame into the plan's inputs; the image normalization and the
LSS grid's constants made once leave the encode unchanged. On a card:
replayed encodes equal eager ones bit for bit at B = 1 and B = 2, a window
is left as it was by the next frame's replay, and a stream's results equal
those of an evaluator that encodes eagerly. No JAX, so on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_decode_graphs.py
"""

import warnings

import numpy as np
import pytest
import torch

from racformer_tpu_torch.data import SyntheticDataset
from racformer_tpu_torch.eval import StreamingEvaluator, graphs
from racformer_tpu_torch.eval.streaming import prepare_frame
from racformer_tpu_torch.model import RaCFormer, random_init_
from racformer_tpu_torch.model import racformer
from racformer_tpu_torch.nn import bev_sampling, head, img_sampling
from racformer_tpu_torch import ops
from racformer_tpu_torch.ops import (bbox_codec, bev_pool, deform_attn,
                                     gather_kernel, msmv)
from racformer_tpu_torch.utils import tracing

TINY = dict(num_cams=2, num_frames=2, embed_dims=64, num_query=12,
            num_clusters=2, image_hw=(64, 128), depth_bins=16,
            bev_size=(32, 32), max_gt=8, num_decoder_layers=2,
            trunk_dtype=torch.float32)
LAYERS = TINY["num_decoder_layers"]


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
def frames():
    data = SyntheticDataset(num_samples=6, num_cams=2, num_frames=2,
                            hw=(64, 128), max_radar_points=64, max_gt=8)
    return [prepare_frame(data[i], 0.5 * i, False) for i in range(len(data))]


def tiny_model(device="cpu"):
    m = RaCFormer(**TINY, decoder={"gather_dtype": torch.float32})
    random_init_(m, torch.Generator().manual_seed(0))
    return m.to(device).eval()


def decode_counts():
    return [r.counts for r in tracing.records() if r.name == "eval.decode_window"]


def encode_counts():
    return [r.counts for r in tracing.records() if r.name == "eval.encode_frame"]


def uploaded(fs, device="cpu"):
    """The encoder's inputs (`graphs.ENCODED`) of frames `fs`, stacked
    [B, ...] as the evaluator uploads them."""
    return tuple(torch.from_numpy(np.stack([np.asarray(f[k]) for f in fs]))
                 .to(device) for k in graphs.ENCODED)


def test_cpu_decodes_eagerly_and_counts_it(frames):
    ev = StreamingEvaluator(tiny_model())
    replays = graphs.GRAPH_REPLAYS
    tracing.enable()
    for f in frames[:3]:
        ev.step(f)
    ev.reset()
    ev.step_batch(frames[3:5], [True, True])
    tracing.disable()
    assert decode_counts() == [{"eager_decodes": 1}] * 4
    assert ev.decoder_graphs.plans == {} and graphs.GRAPH_REPLAYS == replays


@pytest.mark.parametrize("fused_gather, folds", [(None, True), (True, True),
                                                 (False, False)])
def test_only_a_folding_decoder_is_captured(frames, fused_gather, folds,
                                            monkeypatch):
    """With the kernels taken (as on a card), a decode has a replay key
    exactly when the model's decoder folds: the unfolded samplers launch K2,
    which a graph would hide from its counter."""
    model = RaCFormer(**TINY, decoder={"gather_dtype": torch.float32},
                      fused_gather=fused_gather).eval()
    ev = StreamingEvaluator(model)
    ev.step(frames[0])
    monkeypatch.setattr(gather_kernel, "use_reference", lambda x: False)
    assert model.folds is folds
    with torch.no_grad():
        assert (graphs.replay_key(model, ev.cache) is not None) is folds


class StubGraph:
    """Stands in for `torch.cuda.CUDAGraph` on the CPU: captures nothing
    (the stubbed capture runs the work eagerly); `capture_end` warns
    `WARNING` when set."""

    WARNING = None

    def capture_begin(self, **kwargs):
        pass

    def capture_end(self):
        if self.WARNING:
            warnings.warn(self.WARNING)


def tree(span):
    """The captured steps as nested lists: "graph", ("K1", site) and
    (span name, [steps])."""
    out = []
    for step in span.steps:
        if isinstance(step, graphs._Span):
            out.append((step.name, tree(step)))
        elif isinstance(step, graphs._K1):
            out.append(("K1", step.site))
        else:
            out.append("graph")
    return out


def test_capture_cuts_at_k1_calls_and_spans(frames, monkeypatch):
    """Each iteration: a graph, K1 at the radar BEV, LSS BEV and image
    sites with a graph after each, inside its `head.iteration` span inside
    `model.head`; the call sites and the listener are left as they were,
    and the captured K1 calls take the arguments the sites were given."""
    model = tiny_model()
    ev = StreamingEvaluator(model)
    for f in frames[:2]:
        ev.step(f)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    before = (msmv.patch_sample_fold, deform_attn.patch_sample_fold)
    with torch.no_grad():
        root, outs = graphs._Capture(None).run(
            lambda: graphs.decode_window(model, ev.cache))
    assert (msmv.patch_sample_fold, deform_attn.patch_sample_fold) == before
    assert tracing._listener is None
    iteration = ["graph", ("K1", deform_attn), "graph", ("K1", deform_attn),
                 "graph", ("K1", msmv), "graph"]
    assert tree(root) == ["graph", ("model.head", [
        "graph", ("head.iteration", iteration), "graph",
        ("head.iteration", iteration), "graph"]), "graph"]
    assert root.graphs() == 2 + 1 + 2 * 5
    k1 = [s for it in root.steps[1].steps if isinstance(it, graphs._Span)
          for s in it.steps if isinstance(s, graphs._K1)]
    for step in k1:
        fused, row, x0p, wx, wy, wl, fold = step.args
        assert step.out.shape == (fused.shape[0], row.shape[1] // fold,
                                  fused.shape[-1] // 2)
        assert all(t.dtype == torch.int32 for t in (row, x0p))
    assert [s.args[-1] for s in k1] == [4, 4, 4] * LAYERS
    assert set(outs) == {"all_cls_scores", "all_bbox_preds"}


@pytest.mark.parametrize("warning, kept", [(graphs.EMPTY + ".", False),
                                           ("another warning", True)])
def test_a_capture_of_no_work_leaves_no_graph(warning, kept, monkeypatch):
    """A cut whose capture torch reports empty adds no graph to replay;
    any other warning of the capture's end is passed on and the graph
    kept."""
    monkeypatch.setattr(StubGraph, "WARNING", warning)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        root, _ = graphs._Capture(None).run(lambda: None)
    assert root.graphs() == int(kept)
    assert [str(w.message) for w in caught] == [warning] * kept


def test_a_replay_copies_the_window_into_the_plans_inputs():
    """A replay copies the window it is given into the plan's inputs,
    leaves the window as it was and runs the captured steps in order."""
    g = torch.Generator().manual_seed(2)
    window = tuple(torch.randn(1, 4, n, generator=g) for n in (3, 5))
    ran = []

    class Step:
        def __init__(self, i):
            self.i = i

        def run(self):
            ran.append(self.i)

        def graphs(self):
            return 1

    root = graphs._Span(None)
    root.steps = [Step(0), Step(1)]
    plan = graphs._Plan(tuple(torch.zeros_like(t) for t in window), root,
                        {"out": torch.ones(1)})
    kept = tuple(t.clone() for t in window)
    assert plan.replay(window) is plan.outs and plan.graphs == 2
    assert ran == [0, 1]
    for x, w, k in zip(plan.inputs, window, kept):
        assert x is not w and torch.equal(x, w) and torch.equal(w, k)


def test_device_constants_leave_the_head_unchanged(frames, monkeypatch):
    """The pc_range tensors made once give the head's outputs bit for bit
    as tensors made at each call did."""
    lo = ops.device_constant((-51.2, -51.2, -5.0), torch.device("cpu"))
    assert lo is ops.device_constant((-51.2, -51.2, -5.0), torch.device("cpu"))
    assert torch.equal(lo, torch.tensor([-51.2, -51.2, -5.0]))

    def run():
        ev = StreamingEvaluator(tiny_model())
        return [ev.step(f) for f in frames[:3]]

    want = run()
    per_call = lambda values, device, dtype=torch.float32: torch.tensor(
        values, dtype=dtype, device=device)
    for mod in (bbox_codec, head, bev_sampling, img_sampling):
        monkeypatch.setattr(mod, "device_constant", per_call)
    got = run()
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cpu_encodes_eagerly_and_counts_it(frames):
    ev = StreamingEvaluator(tiny_model())
    replays = graphs.GRAPH_REPLAYS
    tracing.enable()
    for f in frames[:3]:
        ev.step(f)
    ev.reset()
    ev.step_batch(frames[3:5], [True, True])
    tracing.disable()
    assert encode_counts() == [{"eager_encodes": 1}] * 4
    assert ev.encoder_graphs.plans == {} and graphs.GRAPH_REPLAYS == replays


@pytest.mark.parametrize("training, grad", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_only_an_eval_encode_without_gradients_is_captured(
        frames, training, grad, monkeypatch):
    """On a card (the CPU taken for one here), an encode has a key exactly
    in eval mode with gradients off; the key tells batch sizes apart."""
    monkeypatch.setattr(graphs, "DEVICES", ("cpu", "cuda"))
    model = tiny_model().train(training)
    with torch.set_grad_enabled(grad):
        keys = [graphs.encode_key(model, uploaded(frames[:b])) for b in (1, 2)]
    if training or grad:
        assert keys == [None, None]
    else:
        assert None not in keys and keys[0] != keys[1]
    monkeypatch.setattr(graphs, "DEVICES", ("cuda",))
    with torch.no_grad():
        assert graphs.encode_key(tiny_model(), uploaded(frames[:1])) is None


def test_an_encode_capture_cuts_at_the_trunk_and_the_bev(frames, monkeypatch):
    """The encode's graphs: the normalization, then one inside each of
    `model.trunk` and `model.bev` (the stub keeps the cuts between and after
    them, which torch reports empty on a card); the capture calls no K1 and
    gives the eager encode's outputs."""
    model = tiny_model()
    frame = uploaded(frames[:1])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    with torch.no_grad():
        root, outs = graphs._Capture(None).run(
            lambda: graphs.encode_frame(model, frame))
        want = graphs.encode_frame(model, frame)
    assert tree(root) == ["graph", ("model.trunk", ["graph"]), "graph",
                          ("model.bev", ["graph"]), "graph"]
    assert tracing._listener is None
    assert len(outs) == len(want) == 3
    for o, w in zip(outs, want):
        assert torch.equal(o, w)


def stub_capture(fn, model, inputs):
    """`graphs.capture` without the CUDA streams, on `StubGraph`s."""
    root, outs = graphs._Capture(None).run(lambda: fn(model, inputs))
    return graphs._Plan(tuple(inputs), root, outs)


def test_encodes_replay_a_plan_per_batch_size(frames, monkeypatch):
    """With the CPU taken for a card and stub graphs: B = 1 (`step`) and
    B = 2 (`step_batch`) each encode eagerly once, are captured at their
    second encode and replayed from then on, each under its own key; a
    replay copies the frame into the plan's inputs, which stay the plan's
    own, and counts its graphs."""
    monkeypatch.setattr(graphs, "DEVICES", ("cpu", "cuda"))
    monkeypatch.setattr(graphs, "capture", stub_capture)
    monkeypatch.setattr(StubGraph, "replay", lambda self: None, raising=False)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    ev = StreamingEvaluator(tiny_model())
    replays = graphs.GRAPH_REPLAYS
    tracing.enable()
    for f in frames[:3]:
        ev.step(f)
    ev.reset()
    for t in range(3):
        ev.step_batch(frames[t:t + 2], [t == 0] * 2)
    tracing.disable()
    one, two = ev.encoder_graphs.plans.values()
    assert one.graphs == two.graphs == 5  # the stub keeps the empty cuts
    assert encode_counts() == ([{"eager_encodes": 1}] + [
        {"graph_replays": 5}] * 2) * 2
    assert graphs.GRAPH_REPLAYS - replays == 4 * 5
    assert [p.inputs[0].shape[0] for p in (one, two)] == [1, 2]
    for plan, last in ((one, frames[2:3]), (two, frames[2:4])):
        for x, want in zip(plan.inputs, uploaded(last)):
            assert torch.equal(x, want)


def test_device_constants_leave_the_encoder_unchanged(frames, monkeypatch):
    """The image normalization's mean and std and the LSS grid's lower
    corner and interval made once give the encode bit for bit as tensors
    made at each call did."""
    model = tiny_model()
    frame = uploaded(frames[:2])
    x = frame[0]
    want = (x.float().flip(-1) - torch.tensor(racformer.IMG_MEAN)) / \
        torch.tensor(racformer.IMG_STD)
    assert torch.equal(racformer.preprocess_images(x), want)
    view = model.img_lss_view_transformer
    grid = lambda: bev_pool.frustum_grid(
        view.frustum, frame[5][0].float(), view.grid_lower, view.grid_interval,
        view.grid_size)
    with torch.no_grad():
        want, want_grid = graphs.encode_frame(model, frame), grid()
        per_call = lambda values, device, dtype=torch.float32: torch.tensor(
            values, dtype=dtype, device=device)
        for mod in (racformer, bev_pool):
            monkeypatch.setattr(mod, "device_constant", per_call)
        got, got_grid = graphs.encode_frame(model, frame), grid()
    for g, w in zip(got + got_grid, want + want_grid):
        assert torch.equal(g, w)


# --- on a card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and K1 have no CPU mode")
    return torch.device("cuda")


def run_steps(ev, steps):
    """Each step: (frame, reset) through `step` or (B frames, B resets)
    through `step_batch`. Returns the results and each step's K1 launches."""
    outs, launches = [], []
    for f, r in steps:
        before = gather_kernel.LAUNCHES
        if isinstance(f, dict):
            if r:
                ev.reset()
            outs.append(ev.step(f))
        else:
            outs.append(ev.step_batch(f, r))
        launches.append(gather_kernel.LAUNCHES - before)
    return outs, launches


@pytest.fixture
def deterministic():
    """Deterministic algorithms: the encoder's `index_add_` (the LSS splat,
    the pillar sums) otherwise adds in the order its atomics land."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was, warn_only=warn)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_replayed_decodes_equal_eager_ones(cuda, deterministic, frames, batch,
                                           monkeypatch):
    """B = 1: a scene start, three shifted frames, a new scene; B = 4:
    streams resetting at staggered steps. Every decode after the second
    replays; results and K1 launches equal an eager evaluator's."""
    model = tiny_model(cuda)
    if batch == 1:
        steps = [(f, i in (0, 4)) for i, f in enumerate(frames[:5])]
    else:
        resets = [[True] * 4, [False, True, False, False],
                  [False, False, True, False], [False, False, False, True],
                  [True, False, False, False]]
        steps = [([frames[(t + b) % len(frames)] for b in range(4)], r)
                 for t, r in enumerate(resets)]
    with monkeypatch.context() as m:
        m.setattr(graphs, "replay_key", lambda *a: None)
        want, want_k1 = run_steps(StreamingEvaluator(model), steps)
    ev = StreamingEvaluator(model)
    tracing.enable()
    got, got_k1 = run_steps(ev, steps)
    tracing.disable()
    (plan,) = ev.decoder_graphs.plans.values()
    assert isinstance(plan, graphs._Plan)
    assert decode_counts() == [{"eager_decodes": 1}] + [
        {"graph_replays": plan.graphs}] * (len(steps) - 1)
    assert got_k1 == want_k1 == [3 * LAYERS] * len(steps)
    for t, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"t={t} {k}")


@pytest.mark.cuda
def test_torch_still_reports_an_empty_capture(cuda):
    """`_Capture` drops a cut with no work by torch's warning text
    (`graphs.EMPTY`): a capture of nothing leaves no graph and no warning."""
    with warnings.catch_warnings(record=True) as caught, \
            torch.cuda.stream(torch.cuda.Stream()):
        warnings.simplefilter("always")
        root, _ = graphs._Capture(torch.cuda.graph_pool_handle()).run(
            lambda: None)
    assert root.steps == [] and caught == []


@pytest.mark.cuda
def test_results_stay_the_callers(cuda, frames):
    ev = StreamingEvaluator(tiny_model(cuda))
    for f in frames[:2]:
        ev.step(f)
    first = ev.step(frames[2], blocking=False)
    kept = {k: v.clone() for k, v in first.items()}
    second = ev.step(frames[3], blocking=False)
    torch.cuda.synchronize()
    for k in first:
        assert first[k].data_ptr() != second[k].data_ptr()
        assert torch.equal(first[k], kept[k]), k
    assert not torch.equal(first["scores"], second["scores"])
    (plan,) = ev.decoder_graphs.plans.values()
    assert not any(t is x for t in ev.cache for x in plan.inputs)


@pytest.mark.cuda
def test_grad_or_train_mode_never_replays(cuda, frames):
    model = tiny_model(cuda)
    ev = StreamingEvaluator(model)
    for f in frames[:3]:
        ev.step(f)
    replays = graphs.GRAPH_REPLAYS
    assert replays > 0
    model.train()
    try:
        tracing.enable()
        ev.step(frames[3])
        tracing.disable()
    finally:
        model.eval()
    assert decode_counts() == [{"eager_decodes": 1}]
    with torch.enable_grad():
        ev.decoder_graphs(model, ev.cache)
    assert graphs.GRAPH_REPLAYS == replays
    ev.step(frames[4])
    assert graphs.GRAPH_REPLAYS > replays


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_replayed_encodes_equal_eager_ones(cuda, deterministic, frames, batch):
    """Four frames' encodes: the first eager, the second captured, each
    from the second replayed as the three graphs of the normalization,
    `model.trunk` and `model.bev`, bit for bit the eager encode."""
    model = tiny_model(cuda)
    encodes = graphs.EncodeGraphs()
    replays = graphs.GRAPH_REPLAYS
    with torch.no_grad():
        for t in range(4):
            frame = uploaded(frames[t:t + batch], cuda)
            got = [x.clone() for x in encodes(model, frame)]
            want = graphs.encode_frame(model, frame)
            for g, w in zip(got, want):
                assert torch.equal(g, w), t
    (plan,) = encodes.plans.values()
    assert tree(plan.root) == ["graph", ("model.trunk", ["graph"]),
                               ("model.bev", ["graph"])]
    assert graphs.GRAPH_REPLAYS - replays == 3 * plan.graphs == 9


@pytest.mark.cuda
def test_a_window_outlives_the_next_replay(cuda, frames):
    """The window built from a frame, at a scene start and shifted, is left
    as it was by the next frame's replayed encode: it shares no memory with
    the plan's outputs."""
    ev = StreamingEvaluator(tiny_model(cuda))
    for f in frames[:2]:
        ev.step(f)
    ev.reset()
    (plan,) = ev.encoder_graphs.plans.values()
    outs = {x.untyped_storage().data_ptr() for x in plan.outs}
    for f, g in zip(frames[2:5], frames[3:6]):
        ev.step(f)
        held, kept = ev.cache, [x.clone() for x in ev.cache]
        assert not outs & {x.untyped_storage().data_ptr() for x in held}
        ev.step(g)
        for h, k in zip(held, kept):
            assert torch.equal(h, k)


@pytest.mark.cuda
def test_replayed_encodes_leave_the_results_unchanged(cuda, deterministic,
                                                      frames, monkeypatch):
    """Six frames through `step` (a scene start, four shifted, a new
    scene): the results equal those of the same evaluator with its encoder
    kept eager, bit for bit."""
    model = tiny_model(cuda)
    steps = [(f, i in (0, 4)) for i, f in enumerate(frames)]
    with monkeypatch.context() as m:
        m.setattr(graphs, "encode_key", lambda *a: None)
        ev = StreamingEvaluator(model)
        want, _ = run_steps(ev, steps)
        assert ev.encoder_graphs.plans == {}
    ev = StreamingEvaluator(model)
    tracing.enable()
    got, _ = run_steps(ev, steps)
    tracing.disable()
    (plan,) = ev.encoder_graphs.plans.values()
    assert encode_counts() == [{"eager_encodes": 1}] + [
        {"graph_replays": plan.graphs}] * (len(steps) - 1)
    for t, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"t={t} {k}")
