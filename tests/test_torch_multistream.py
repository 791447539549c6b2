"""The port's multi-stream streaming eval (`step_batch`, `run_multistream`)
against its own single-stream `step()` and against the JAX package.

Both packages run the same weights (the port's seeded random weights,
carried over by the JAX package's `convert_state_dict`) at the tiny config of
`tests/test_drivers.py` (2 cameras, 2 frames, embed_dims 64, 12 queries,
64x128 images, a 32^2 BEV grid), float32 everywhere; the JAX side takes its
plain gather path on the CPU, the port its kernels' plain versions. Frames
come from ring cameras, so the decoder's image sample points land in view.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.eval import streaming as jstreaming
from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.tools.convert_weights import convert_state_dict

from racformer_tpu_torch.eval import streaming
from racformer_tpu_torch.eval.streaming import (
    StreamingEvaluator, prepare_frame, radar_maps_are_columns,
    run_multistream, run_single_stream, sample_timestamp)
from racformer_tpu_torch.model import RaCFormer, random_init_
from tests.test_torch_slice import ring_batch

TINY = dict(num_cams=2, num_frames=2, embed_dims=64, num_query=12,
            num_clusters=2, image_hw=(64, 128), depth_bins=16,
            bev_size=(32, 32), max_gt=8)
FIELDS = ("imgs", "radar_points", "radar_mask", "radar_depth", "radar_rcs",
          "lidar2img", "img2lidar")


def frame(seed, ts):
    """One frame of ring cameras: raw uint8 images and dense radar maps."""
    b = ring_batch(seed, T=1)
    f = {k: b[k][0, 0] for k in FIELDS}
    f["imgs"] = f["imgs"].astype(np.uint8)
    f["timestamp"] = ts
    return f


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny steps: the test runner's
    workers share the cores, and spinning thread pools there cost ~50x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """The port model with seeded random weights (no zero kernels) and the
    JAX model with the same weights, converted by the JAX package's own
    converter into a template of the JAX model's variables (shapes only:
    nothing of the JAX model is compiled here)."""
    b = ring_batch(0)
    model = RaCFormer(**TINY, trunk_dtype=torch.float32,
                      decoder={"gather_dtype": torch.float32})
    random_init_(model, torch.Generator().manual_seed(1))
    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32,
                          decoder={"gather_dtype": jnp.float32},
                          train_mode=False)
    jargs = [jax_preprocess(jnp.asarray(b["imgs"]))] + [
        jnp.asarray(b[k]) for k in FIELDS[1:] + ("time_diff",)]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *jargs))
    variables, unmatched = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, template,
        strict=True)
    assert unmatched == []
    return jmodel, variables, model.eval()


# stream 0: scene A frames 0..2; stream 1: scene B frame 0, then scene C
# frames 0..1, a reset at t = 1 while stream 0 keeps its window
S0 = [frame(10, 0.0), frame(11, 0.5), frame(12, 1.0)]
S1 = [frame(13, 0.0), frame(14, 0.0), frame(15, 0.5)]
RESETS = [(True, True), (False, True), (False, False)]


def stacked(frames):
    """The pre-batched dict form of one lockstep step."""
    out = {k: torch.from_numpy(np.stack([f[k] for f in frames]))
           for k in FIELDS}
    out["timestamp"] = torch.tensor([f["timestamp"] for f in frames])
    return out


def single_stream(model, frames, resets):
    ev = StreamingEvaluator(model)
    outs = []
    for f, r in zip(frames, resets):
        if r:
            ev.reset()
        outs.append(ev.step(f))
    return outs


# one stream with a reset mid-sequence, for B = 1 lockstep
B1_FRAMES, B1_RESETS = [S0[0], S0[1], S1[1], S1[2]], [True, False, True, False]


@pytest.fixture(scope="module")
def single(models):
    """The step() sequences of the B = 1 stream and of streams 0 and 1."""
    _, _, model = models
    return (single_stream(model, B1_FRAMES, B1_RESETS),
            [single_stream(model, S0, [True, False, False]),
             single_stream(model, S1, [True, True, False])])


@pytest.mark.parametrize("form", ["list", "dict"])
def test_step_batch_b1_equals_step_exactly(models, single, form):
    """B = 1 lockstep (a reset mid-sequence included) gives step()'s
    results bit for bit: both shift the window through one function."""
    _, _, model = models
    frames, resets, want = B1_FRAMES, B1_RESETS, single[0]
    ev = StreamingEvaluator(model)
    for t, (f, r) in enumerate(zip(frames, resets)):
        got = ev.step_batch([f] if form == "list" else stacked([f]), [r])
        for k in want[t]:
            np.testing.assert_array_equal(got[k], want[t][k],
                                          err_msg=f"t={t} {k}")


@pytest.mark.parametrize("form", ["list", "dict"])
def test_step_batch_b2_matches_each_streams_step(models, single, form):
    """Two streams in lockstep, stream 1 resetting at t = 1 while stream 0
    keeps its window: each stream matches its own step() sequence within
    the JAX package's own bound (tests/test_streaming.py)."""
    _, _, model = models
    ref = single[1]
    ev = StreamingEvaluator(model)
    for t in range(3):
        pair = [S0[t], S1[t]]
        out = ev.step_batch(pair if form == "list" else stacked(pair),
                            list(RESETS[t]))
        for b in range(2):
            np.testing.assert_allclose(out["scores"][b], ref[b][t]["scores"][0],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"t={t} stream={b}")
            np.testing.assert_allclose(out["bboxes"][b], ref[b][t]["bboxes"][0],
                                       rtol=1e-3, atol=1e-3,
                                       err_msg=f"t={t} stream={b}")
        assert out["scores"].shape[0] == 2


def test_step_batch_matches_jax(models):
    """The port's step_batch against the JAX package's on the same three
    lockstep steps, within test_torch_slice.py's bounds."""
    jmodel, variables, model = models
    jev = jstreaming.StreamingEvaluator(jmodel, variables)
    ev = StreamingEvaluator(model)
    for t in range(3):
        want = jev.step_batch([S0[t], S1[t]], list(RESETS[t]))
        got = ev.step_batch([S0[t], S1[t]], list(RESETS[t]))
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=2e-3,
                                   atol=2e-3, err_msg=f"t={t}")
        np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=2e-2,
                                   atol=2e-2, err_msg=f"t={t}")
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["valid"], want["valid"])


def test_step_batch_contract(models):
    """Absolute timestamps are refused in both forms, a first step without
    every stream resetting is refused, and column-form radar maps [N, W]
    give what the dense maps they stand for give."""
    _, _, model = models
    ev = StreamingEvaluator(model)
    with pytest.raises(ValueError, match="absolute"):
        ev.step_batch([dict(S0[0], timestamp=1.6e9), S1[0]], [True, True])
    with pytest.raises(ValueError, match="absolute"):
        ev.step_batch(dict(stacked([S0[0], S1[0]]),
                           timestamp=torch.tensor([0.0, 1.6e9],
                                                  dtype=torch.float64)),
                      [True, True])
    with pytest.raises(ValueError, match="reset"):
        ev.step_batch([S0[0], S1[0]], [True, False])

    cols = []
    for f in (S0[0], S1[0]):
        c = dict(f)
        for k in ("radar_depth", "radar_rcs"):
            c[k] = f[k][:, 0, :]
        cols.append(c)
    dense = [dict(f) for f in cols]
    for d in dense:
        for k in ("radar_depth", "radar_rcs"):
            d[k] = np.repeat(d[k][:, None, :], TINY["image_hw"][0], axis=1)
    got = ev.step_batch(cols, [True, True])
    want = StreamingEvaluator(model).step_batch(dense, [True, True])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class SceneDataset:
    """5 samples in 2 scenes (3 + 2) with epoch timestamps and ground truth;
    each sample carries the window axis (T = 1) that the real datasets'
    samples carry, and the streaming protocols read its frame 0."""

    def __init__(self):
        self.infos = [{"scene_token": s, "timestamp": 1.6e9 + 0.5 * i}
                      for i, s in enumerate("aaabb")]

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, i):
        b = ring_batch(100 + i, T=1)
        s = {k: b[k][0] for k in FIELDS}
        rng = np.random.default_rng(200 + i)
        s.update(scene=self.infos[i]["scene_token"],
                 timestamp=self.infos[i]["timestamp"],
                 gt_bboxes=rng.normal(size=(8, 9)).astype(np.float32),
                 gt_labels=rng.integers(0, 10, size=(8,)).astype(np.int32),
                 gt_mask=np.arange(8) < 3)
        return s


def test_run_multistream_matches_single_stream(models):
    """The runner over a scene-annotated dataset in 2 streams (and in 4,
    clamped to the 2 scene groups) matches the single-stream loop (val.py's,
    and `run_single_stream`) sample by sample, predictions and ground truth
    in dataset order."""
    _, _, model = models
    ds = SceneDataset()
    ev = StreamingEvaluator(model)
    ref, prev, t0 = [], None, 0.0
    cols = radar_maps_are_columns(ds[0])
    for i in range(len(ds)):
        s = ds[i]
        ts = sample_timestamp(s, i)
        if s["scene"] != prev:
            ev.reset()
            prev, t0 = s["scene"], ts
        ref.append({k: v[0] for k, v in ev.step(prepare_frame(s, ts - t0,
                                                               cols)).items()})
    # the driver's single-stream protocol is that loop
    preds, gts, fps = run_single_stream(StreamingEvaluator(model), ds)
    assert len(gts) == 5 and fps > 0
    for i in range(5):
        for k in ref[i]:
            np.testing.assert_array_equal(preds[i][k], ref[i][k])
    for streams in (2, 4):
        preds, gts, fps = run_multistream(StreamingEvaluator(model), ds, streams)
        assert len(preds) == len(gts) == 5 and fps > 0
        for i in range(5):
            np.testing.assert_allclose(preds[i]["scores"], ref[i]["scores"],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"streams={streams} i={i}")
            np.testing.assert_allclose(preds[i]["bboxes"], ref[i]["bboxes"],
                                       rtol=1e-3, atol=1e-3,
                                       err_msg=f"streams={streams} i={i}")
            np.testing.assert_array_equal(gts[i]["labels"], ds[i]["gt_labels"])


class _Tokens:
    def __init__(self, toks):
        self.infos = [{"scene_token": t} for t in toks]

    def __len__(self):
        return len(self.infos)


class _Anonymous:
    def __len__(self):
        return 7


@pytest.mark.parametrize("dataset, streams", [
    (_Tokens("aaabbc"), 2), (_Tokens("aaabbc"), 4), (_Tokens("abcabc"), 3),
    (_Anonymous(), 3), (_Anonymous(), 1)])
def test_scene_partitioning_matches_jax(dataset, streams):
    """Scene groups and stream plans equal the JAX package's, on the cases
    of tests/test_streaming.py::test_scene_partitioning and more."""
    groups = streaming._scene_groups(dataset)
    assert groups == jstreaming._scene_groups(dataset)
    assert (streaming._assign_streams(groups, streams)
            == jstreaming._assign_streams(groups, streams))
