"""The pieces of the port's training loop against the JAX package, on the
same numpy inputs:

* `config_kwargs` honours every field of a config's `model` block that
  the JAX `RaCFormer` takes (the old copy dropped `bn_frame0_only`
  silently) and refuses unknown fields and values it cannot read, and
  passes the JAX package's five decoder remat policies on;
* `match_cost_cartesian` (1e-5), `ema_update` (1e-6 relative at steps 0,
  1, 2000 and 1e5), `MatchStatsHook` (JSON files byte-equal),
  `detection_loss(with_match=True)` (`_matched_q` equal, `_match_cost`
  1e-5);
* the train step's match statistics in sample order under accumulation,
  and its static loss scale (losses and gradients within 1e-5 of the
  unscaled step's);
* the `bn_frame0_only` train-mode forward and its new BatchNorm statistics
  (the slice tests' tolerances, 1e-3);
* `MetricLogger` (`metrics.jsonl` records equal) and `PrefetchLoader`
  (the same batches in the same order, the same raises; a batch queued
  before a worker's failure is still returned at its own step).
"""

import json
import pathlib
import sys
import threading
import time
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.data.prefetch import PrefetchLoader as JaxPrefetchLoader
from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.tools.convert_weights import convert_state_dict
from racformer_tpu.train import hooks as jhooks
from racformer_tpu.train import losses as jlosses
from racformer_tpu.train import matching as jmatch
from racformer_tpu.utils.logging import MetricLogger as JaxMetricLogger

from racformer_tpu_torch.config import Config
from racformer_tpu_torch.data import SyntheticDataset
from racformer_tpu_torch.data.prefetch import PrefetchLoader
from racformer_tpu_torch.model import (RaCFormer, config_kwargs,
                                       preprocess_images, random_init_)
from racformer_tpu_torch.tools.convert_weights import state_dict_from_jax
from racformer_tpu_torch.train import Optimizer, hooks, losses, matching
from racformer_tpu_torch.train.step import make_draws, make_train_step
from racformer_tpu_torch.utils.logging import MetricLogger

from tests.test_torch_slice import TINY
from tests.test_torch_train_parts import _gt, _outs
from tests.test_torch_train_step import _batch

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "racformer_tpu_torch" / "configs").glob("*.py"))
FLAGSHIP = REPO / "racformer_tpu_torch" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
ARG_KEYS = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
            "lidar2img", "img2lidar", "time_diff")


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test runner's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- config_kwargs ---------------------------------------------------------

def test_config_kwargs_passes_bn_frame0_only():
    """The override reaches the model. The old copy kept only its field
    list, so the same override built a model with the field off."""
    cfg = Config.fromfile(str(FLAGSHIP)).merge_override(
        ["model.bn_frame0_only=True", "model.num_classes=4"])
    kwargs = config_kwargs(cfg)
    old_fields = ("num_cams", "num_frames", "embed_dims", "num_query",
                  "num_clusters", "num_levels", "num_groups", "image_hw",
                  "pc_range", "depth_bins", "bev_size", "query_denoising",
                  "max_gt")
    assert "bn_frame0_only" not in {k for k in cfg["model"] if k in old_fields}
    assert kwargs["bn_frame0_only"] is True and kwargs["num_classes"] == 4
    with torch.device("meta"):
        assert RaCFormer(**kwargs).bn_frame0_only is True


@pytest.mark.parametrize("field", ["trunk_dtype", "head_dtype", "fused_gather",
                                   "num_decoder_layers", "no_such_field"])
def test_config_kwargs_refuses_what_the_port_cannot_honour(field):
    """An unknown field, and a dtype field given something that is not a
    dtype, raise a ValueError that names the field; `fused_gather` and
    `num_decoder_layers`, which the port honours, reach the model."""
    if field in ("fused_gather", "num_decoder_layers"):
        value = {"fused_gather": False, "num_decoder_layers": 2}[field]
        cfg = Config.fromfile(str(FLAGSHIP)).merge_override(
            [f"model.{field}={value}"])
        # the config's decoder block sets num_layers, which wins over the
        # model field in both packages
        del cfg["decoder"]["num_layers"]
        kwargs = config_kwargs(cfg)
        assert kwargs[field] == value
        with torch.device("meta"):
            decoder = RaCFormer(**kwargs).pts_bbox_head.transformer.decoder
        got = {"fused_gather": decoder.fused_gather,
               "num_decoder_layers": decoder.num_layers}[field]
        assert got == value
        return
    cfg = Config.fromfile(str(FLAGSHIP)).merge_override([f"model.{field}=1"])
    with pytest.raises(ValueError, match=field):
        config_kwargs(cfg)


def test_config_kwargs_refuses_other_remat_policies(monkeypatch):
    """The five JAX policies pass through to the decoder; another name
    raises the JAX package's ValueError, from the config or from
    RACFORMER_REMAT_POLICY."""
    monkeypatch.delenv("RACFORMER_REMAT_POLICY", raising=False)
    cfg = Config.fromfile(str(FLAGSHIP))
    for policy in ("full", "dots", "dots_no_batch", "save_sampled",
                   "save_bev"):
        cfg["decoder"]["remat_policy"] = policy
        assert config_kwargs(cfg)["decoder"]["remat_policy"] == policy
    cfg["decoder"]["remat_policy"] = "nope"
    with pytest.raises(ValueError) as port_err:
        config_kwargs(cfg)
    del cfg["decoder"]["remat_policy"]
    monkeypatch.setenv("RACFORMER_REMAT_POLICY", "nope")
    with pytest.raises(ValueError, match="unknown decoder remat_policy"):
        config_kwargs(cfg)
    # the JAX decoder's message, from its source
    src = (REPO / "racformer_tpu" / "nn" / "decoder.py").read_text()
    assert ('f"unknown decoder remat_policy {pol_name!r}; "\n'
            '                f"expected one of {sorted(policies)}")') in src
    names = ["dots", "dots_no_batch", "full", "save_bev", "save_sampled"]
    assert str(port_err.value) == (f"unknown decoder remat_policy 'nope'; "
                                   f"expected one of {names}")


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_config_passes_config_kwargs(path):
    cfg = Config.fromfile(str(path))
    kwargs = config_kwargs(cfg)
    assert kwargs["num_classes"] == len(cfg["class_names"])
    with torch.device("meta"):
        RaCFormer(**kwargs)


# --- matching, EMA, match statistics, losses -------------------------------

@pytest.mark.parametrize("with_velo", [True, False])
@pytest.mark.parametrize("weights", [None, losses.CODE_WEIGHTS])
def test_match_cost_cartesian_matches_jax(with_velo, weights):
    rng = np.random.default_rng(11)
    L, B, Q, G = 2, 2, 30, 6
    boxes, labels, mask = _gt(rng, B, G, [G - 1, 2])
    cls, box, _, _ = _outs(rng, L, B, Q, G)
    want = jax.vmap(jax.vmap(
        lambda c, b, gb, gl, gm: jmatch.match_cost_cartesian(
            c, b, gb, gl, gm, weights, with_velo=with_velo)),
        in_axes=(0, 0, None, None, None))(cls, box, boxes, labels, mask)
    got = matching.match_cost_cartesian(
        t(cls), t(box), t(boxes)[None], t(labels)[None], t(mask)[None],
        weights, with_velo=with_velo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 2000, 100_000])
def test_ema_update_matches_jax(step):
    rng = np.random.default_rng(step)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 5)}
    ema = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    want = jhooks.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                             {k: jnp.asarray(v) for k, v in params.items()},
                             jnp.float32(step))
    got = {k: t(v) for k, v in ema.items()}
    hooks.ema_update(got, {k: t(v) for k, v in params.items()}, step)
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_ema_is_a_clone_of_the_parameters():
    model = torch.nn.Linear(3, 2)
    ema = hooks.ema_init(model)
    with torch.no_grad():
        model.weight.add_(1.0)
    assert not torch.equal(ema["weight"], model.weight)
    assert ema["weight"].dtype == torch.float32


def test_match_stats_files_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    L, B, G = 3, 2, 6
    port = hooks.MatchStatsHook(str(tmp_path / "port"), rank=1)
    ref = jhooks.MatchStatsHook(str(tmp_path / "jax"), rank=1)
    for epoch, steps in ((0, (0, 1)), (1, (2,))):
        for s in steps:
            metrics = {"_matched_q": rng.integers(0, 900, (L, B, G)).astype(np.int32),
                       "_match_cost": rng.normal(size=(L, B, G)).astype(np.float32),
                       "loss_total": 1.0}
            labels = rng.integers(0, 10, (B, G))
            mask = rng.uniform(size=(B, G)) < 0.6
            port.record(s, metrics, labels, mask)
            ref.record(s, metrics, labels, mask)
        port.after_epoch(epoch)
        ref.after_epoch(epoch)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.json"))
    assert len(files) == 2 * L
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.json"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f


def test_detection_loss_with_match_matches_jax():
    rng = np.random.default_rng(8)
    L, B, Q, G, ng = 2, 2, 20, 5, 3
    boxes, labels, mask = _gt(rng, B, G, [5, 2])
    cls, box, dn_cls, dn_box = _outs(rng, L, B, Q, G, ng)
    dn_valid = np.tile(mask, (1, ng))
    want = jax.jit(lambda o, b, l, m: jlosses.detection_loss(
        o, b, l, m, with_match=True))(
        {"all_cls_scores": jnp.asarray(cls), "all_bbox_preds": jnp.asarray(box),
         "dn_cls_scores": jnp.asarray(dn_cls),
         "dn_bbox_preds": jnp.asarray(dn_box),
         "dn_meta": {"dn_valid": jnp.asarray(dn_valid)}},
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    got = losses.detection_loss(
        {"all_cls_scores": t(cls), "all_bbox_preds": t(box),
         "dn_cls_scores": t(dn_cls), "dn_bbox_preds": t(dn_box),
         "dn_valid": t(dn_valid)},
        t(boxes), t(labels), t(mask), with_match=True)
    assert set(got) == set(want)
    assert isinstance(got["_matched_q"], np.ndarray)
    assert got["_matched_q"].dtype == np.int32
    np.testing.assert_array_equal(got["_matched_q"],
                                  np.asarray(want["_matched_q"]))
    np.testing.assert_allclose(got["_match_cost"],
                               np.asarray(want["_match_cost"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["loss_total"]),
                               float(want["loss_total"]), rtol=1e-5)


# --- the train step --------------------------------------------------------

class _Stub(torch.nn.Module):
    """A stand-in detector whose outputs for sample i are row i of fixed
    arrays (the sample index rides in time_diff[:, 0]), times one
    parameter."""

    num_classes = 10
    image_hw = (8, 8)
    pts_bbox_head = SimpleNamespace(dn_groups=1, num_classes=10)

    def __init__(self, cls, box):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))
        self.cls, self.box = t(cls), t(box)

    def forward(self, imgs, *args, gt_bboxes=None, gt_labels=None,
                gt_mask=None, dn=None):
        idx = args[-1][:, 0].long()
        return {"all_cls_scores": self.cls[:, idx] * self.scale,
                "all_bbox_preds": self.box[:, idx] * self.scale}


def test_match_stats_come_back_in_sample_order():
    """Accumulation over 2 interleaved microbatches: `_matched_q` and
    `_match_cost` of the step equal the full-batch loss's on the same
    outputs, sample by sample, and the averaged losses equal its losses."""
    rng = np.random.default_rng(9)
    L, B, Q, G = 2, 4, 16, 5
    boxes, labels, mask = _gt(rng, B, G, [5, 3, 1, 4])
    cls, box, _, _ = _outs(rng, L, B, Q, G)
    model = _Stub(cls, box)
    opt = Optimizer(model.named_parameters(), total_steps=10)
    batch = {"imgs": torch.zeros(B, 1, 1, 8, 8, 3),
             **{k: torch.zeros(B, 1) for k in ARG_KEYS[:-1]},
             "time_diff": torch.arange(B, dtype=torch.float32)[:, None],
             "gt_bboxes": t(boxes), "gt_labels": t(labels), "gt_mask": t(mask)}
    step = make_train_step(model, opt, accum_steps=2, match_stats=True)
    got = step(batch, torch.Generator().manual_seed(0))
    want = losses.detection_loss(
        {"all_cls_scores": t(cls), "all_bbox_preds": t(box)}, t(boxes),
        t(labels), t(mask), with_match=True)
    assert got["_matched_q"].shape == (L, B, G)
    np.testing.assert_array_equal(got["_matched_q"], want["_matched_q"])
    np.testing.assert_array_equal(got["_match_cost"], want["_match_cost"])
    for k in want:
        if not k.startswith("_"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)


def _tiny_model():
    model = RaCFormer(num_cams=2, num_frames=2, embed_dims=64, num_query=12,
                      num_clusters=2, image_hw=(64, 128), depth_bins=16,
                      bev_size=(32, 32), max_gt=8, decoder={"num_layers": 2},
                      trunk_dtype=torch.float32)
    return random_init_(model, torch.Generator().manual_seed(2)).train()


def test_loss_scale_matches_unscaled_step():
    """loss_scale=512: the losses, the (unscaled) gradient norm and every
    gradient as the unscaled step's, within 1e-5 relative."""
    ds = SyntheticDataset(num_samples=1, num_cams=2, num_frames=2,
                          hw=(64, 128), max_radar_points=64, max_gt=8)
    batch = {k: t(v) for k, v in ds.batch([0]).items()}
    depth = dict(num_bins=16)
    runs = []
    for scale in (0.0, 512.0):
        model = _tiny_model()
        opt = Optimizer(model.named_parameters(), total_steps=10)
        draws = [make_draws(model, batch, torch.Generator().manual_seed(5))]
        step = make_train_step(model, opt, depth, loss_scale=scale)
        runs.append((step(batch, draws=draws), model))
    (m0, plain), (m1, scaled) = runs
    assert set(m0) == set(m1) and "loss_depth" in m0
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-5,
                                   err_msg=k)
    grads = dict(plain.named_parameters())
    for name, p in scaled.named_parameters():
        g0 = grads[name].grad.numpy()
        np.testing.assert_allclose(p.grad.numpy(), g0, rtol=1e-5,
                                   atol=1e-5 * np.abs(g0).max(), err_msg=name)


# --- bn_frame0_only ---------------------------------------------------------

def test_bn_frame0_only_forward_matches_jax(monkeypatch):
    """The train-mode forward with `bn_frame0_only` (frame 0's BEV branches
    in train mode, the history frame's in eval mode): head outputs, depth
    logits and the new BatchNorm statistics as JAX's with the same field,
    from the port's seeded random weights converted to flax. The same
    weights without the field move the statistics elsewhere."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    batch = _batch(0)
    G = batch["gt_bboxes"].shape[1]
    gt = ("gt_bboxes", "gt_labels", "gt_mask")

    def port_model(frame0_only):
        return RaCFormer(**TINY, trunk_dtype=torch.float32, max_gt=G,
                         decoder={"gather_dtype": torch.float32},
                         query_denoising=False, bn_frame0_only=frame0_only)

    weights = random_init_(port_model(True), torch.Generator().manual_seed(4))
    sd = {k: v.numpy().copy() for k, v in weights.state_dict().items()}
    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32, max_gt=G,
                          decoder={"gather_dtype": jnp.float32},
                          query_denoising=False, bn_frame0_only=True,
                          train_mode=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jargs = [jax_preprocess(jb["imgs"])] + [jb[k] for k in ARG_KEYS]
    rngs = {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda *a: jmodel.init(
        rngs, *a, **{k: jb[k] for k in gt}), *jargs)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    variables, unmatched = convert_state_dict(sd, template, strict=True)
    assert unmatched == []
    want, upd = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, **{k: jb[k] for k in gt}, rngs=rngs,
        mutable=["batch_stats"]))(variables, *jargs)
    new_stats = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        weights)

    tb = {k: t(v) for k, v in batch.items()}
    stats = {}
    for frame0_only in (True, False):
        model = port_model(frame0_only)
        model.load_state_dict(weights.state_dict())
        model.train()
        got = model(preprocess_images(tb["imgs"]), *[tb[k] for k in ARG_KEYS],
                    **{k: tb[k] for k in gt})
        stats[frame0_only] = {k: v for k, v in model.state_dict().items()
                              if k.endswith(("running_mean", "running_var"))}
        if frame0_only:
            for k in ("all_cls_scores", "all_bbox_preds", "depth_logits"):
                np.testing.assert_allclose(got[k].detach().numpy(),
                                           np.asarray(want[k]), rtol=1e-3,
                                           atol=2e-3, err_msg=k)
            assert all(m.training for m in model.modules())
    for k, v in stats[True].items():
        np.testing.assert_allclose(v.numpy(), new_stats[k].numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    vt = [k for k in stats[True] if k.startswith("img_lss_view_transformer")]
    assert vt and any(not np.allclose(stats[False][k].numpy(),
                                      new_stats[k].numpy(), rtol=1e-3,
                                      atol=1e-3) for k in vt)


# --- MetricLogger and PrefetchLoader ---------------------------------------

def test_metric_logger_records_equal_jax(tmp_path, monkeypatch):
    """The same calls give the same `metrics.jsonl` (TensorBoard, which
    both loggers take only where it is installed, left out)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rng = np.random.default_rng(1)
    loggers = {"port": MetricLogger(str(tmp_path / "port"), total_steps=6,
                                    log_interval=2),
               "jax": JaxMetricLogger(str(tmp_path / "jax"), total_steps=6,
                                      log_interval=2)}
    for s in range(6):
        metrics = {"loss_total": float(rng.normal()),
                   "grad_norm": np.float32(rng.uniform())}
        for lg in loggers.values():
            lg.log_step(s, metrics, lr=1e-4 * s)
    for lg in loggers.values():
        lg.log_eval(6, {"NDS": 0.25, "mAP": 0.125})
    loggers["port"].close()
    recs = {k: [json.loads(line) for line in
                (tmp_path / k / "metrics.jsonl").read_text().splitlines()]
            for k in loggers}
    assert [r["step"] for r in recs["jax"]] == [0, 2, 4, 6]
    assert recs["port"] == recs["jax"]


def _index_fn(step):
    return [(3 * step) % 7, (3 * step + 1) % 7]


def test_prefetch_loader_batches_equal_jax():
    ds = SyntheticDataset(num_samples=7, num_cams=1, num_frames=2,
                          hw=(32, 64), max_radar_points=16, max_gt=4)
    port = PrefetchLoader(ds, _index_fn, 5, start_step=1, num_workers=2)
    ref = JaxPrefetchLoader(ds, _index_fn, 5, start_step=1, num_workers=2)
    try:
        for step in range(1, 5):
            got, want = port.get(step), ref.get(step)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(
                got["gt_bboxes"], ds.batch(_index_fn(step))["gt_bboxes"])
    finally:
        port.close()
        ref.close()


class _Failing:
    """Sample `bad` raises; it first waits for `release` to be set."""

    def __init__(self, bad, release=None):
        self.bad = bad
        self.release = release

    def __getitem__(self, idx):
        if idx == self.bad:
            if self.release is not None:
                assert self.release.wait(timeout=60)
            raise ValueError(f"sample {idx} is unreadable")
        return {"x": np.full((2,), idx)}


@pytest.mark.parametrize("cls", [PrefetchLoader, JaxPrefetchLoader],
                         ids=["port", "jax"])
def test_prefetch_loader_raises_as_jax(cls):
    """Asked for another step than the next: out of sync. A worker's
    exception reaches the consumer at the step that hit it. The bad sample
    fails only once step 0's batch has been taken, so both loaders (the
    JAX package's raises a worker's error after any batch it pops) see
    the same order of events in every run."""
    loader = cls(_Failing(bad=-1), _index_fn, 3)
    try:
        with pytest.raises(RuntimeError, match="out of sync"):
            loader.get(1)
    finally:
        loader.close()
    release = threading.Event()
    loader = cls(_Failing(bad=4, release=release), _index_fn, 3)  # step 1
    try:                                                       # reads 3, 4
        np.testing.assert_array_equal(loader.get(0)["x"], [[0, 0], [1, 1]])
        release.set()
        with pytest.raises(ValueError, match="sample 4"):
            loader.get(1)
    finally:
        release.set()
        loader.close()


def test_prefetch_loader_returns_batches_queued_before_a_failure():
    """The race the port's loader closes: the worker has already failed on
    step 1 when step 0 is asked for; step 0's batch, queued before the
    failure, is still returned, and step 1 raises."""
    loader = PrefetchLoader(_Failing(bad=4), _index_fn, 3)
    try:
        deadline = time.monotonic() + 60
        while loader._err is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert loader._err is not None
        np.testing.assert_array_equal(loader.get(0)["x"], [[0, 0], [1, 1]])
        with pytest.raises(ValueError, match="sample 4"):
            loader.get(1)
    finally:
        loader.close()
