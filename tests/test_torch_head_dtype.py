"""The bf16 decoder / head (`RaCFormer(head_dtype=torch.bfloat16)`, the JAX
package's `head_dtype=jnp.bfloat16`) of the port against the JAX package on
the CPU, and the model fields a config gives both drivers.

The contract is the JAX package's (`tests/test_head_dtype.py`): parameters
stay float32, the decoder and head compute in bf16, coordinate and box
math stays float32, and the class scores and boxes come out float32. The
JAX program rounds to bf16 where XLA's CPU backend does (`nn/layers.py`'s
module docstring says where); the port rounds at the same places, so its
bf16 outputs track JAX's bf16 outputs, not merely its f32 ones.

* The eval forward at `tests/test_torch_slice.py`'s tiny config (2
  cameras, 2 frames, embed_dims 256, 12 queries, 2 decoder layers, f32
  trunk and maps, the fold gather): outputs f32 and finite, parameters
  f32; the port's bf16 scores and boxes no farther (max abs) from JAX's
  bf16 ones than JAX's bf16 ones are from JAX's f32 ones (measured at
  0.0156 against 0.0216 for the scores, 0.0973 against 0.1059 m for the
  boxes); the f32 head still within the slice test's 1e-3 / 2e-3.
* One train step of the VoD config (`tests/test_torch_vod_train.py`'s
  pair, 2 decoder layers, the JAX samplers' custom VJP in interpret mode)
  with a bf16 head on both sides. Tolerances, from this step's
  measurements (at one and at four intra-op threads: the bf16 backward's
  sums depend on the thread count): losses 2e-3 relative (measured at most
  9.5e-4; JAX's own bf16 head moves them by up to 2.0e-3 from its f32
  head), grad_norm 3e-2 (measured 2.1e-2 and 5.2e-3; JAX's bf16 gradient
  of the query boxes has a norm 14% above its f32 one), each gradient
  tensor within cosine 0.95 of JAX's (measured at least 0.957; JAX's bf16
  gradients lie within 0.954 of its f32 ones), and all of them within
  0.12 relative in norm (measured 0.082 and 0.093; JAX's bf16 gradients
  lie 0.137 from its f32 ones). A tensor that is zero
  but for rounding (a bias before a train-mode BatchNorm) is held to 1e-6
  of the largest gradient. Every parameter is still f32 after the step.
* The five remat policies with a bf16 head: gradients bit for bit
  "full"'s; `step_batch` at B = 1 bit for bit `step()`, and the offline
  forward on the same window within bf16 rounding of it.
* The radar temporal encoder at T = 4 frames: forward and parameter
  gradients against the JAX module's in f32 (1e-4), the ConvGRU's states
  of steps t > 1 taking no gradient (a repair: the port used to pass
  their gradient to the cell and the downsample).
* `config_kwargs` takes every field of the JAX `RaCFormer` but
  `train_mode`; the overrides `model.head_dtype=bfloat16
  model.trunk_dtype=float32 model.num_decoder_layers=2
  model.fused_gather=false` reach the model; both drivers run under them
  with `--device cpu`.
"""

import contextlib
import dataclasses
import io
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.nn.conv_gru import RadarBEVTemporalEncoder as JaxEncoder

from racformer_tpu_torch.config import Config
from racformer_tpu_torch.eval import StreamingEvaluator
from racformer_tpu_torch.eval import __main__ as eval_driver
from racformer_tpu_torch.model import (RaCFormer, config_kwargs,
                                       preprocess_images, random_init_)
from racformer_tpu_torch.model.racformer import CONFIG_FIELDS
from racformer_tpu_torch.nn.conv_gru import RadarBEVTemporalEncoder
from racformer_tpu_torch.nn import decoder as port_decoder
from racformer_tpu_torch.tools.convert_weights import (grads_from_jax,
                                                       state_dict_from_jax)
from racformer_tpu_torch.train import __main__ as train_driver

from tests.test_drivers import TINY as DRIVER_TINY
from tests.test_torch_multistream import FIELDS, frame
from tests.test_torch_remat import step_with
from tests.test_torch_slice import ARG_KEYS, TINY, perturb, ring_batch
from tests.test_torch_train_step import _unclip
from tests.test_torch_vod_train import _run_step_pair

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / "racformer_tpu_torch" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
OVERRIDES = ["model.head_dtype=bfloat16", "model.trunk_dtype=float32",
             "model.num_decoder_layers=2", "model.fused_gather=false"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny runs: the test runner's
    workers share the cores, and spinning thread pools there cost ~50x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the eval forward ---------------------------------------------------------

def _jax_model(head_dtype):
    return JaxRaCFormer(**TINY, trunk_dtype=jnp.float32, head_dtype=head_dtype,
                        decoder={"gather_dtype": jnp.float32},
                        fused_gather=True, train_mode=False)


def _port_model(variables, head_dtype):
    model = RaCFormer(**TINY, trunk_dtype=torch.float32, head_dtype=head_dtype,
                      decoder={"gather_dtype": torch.float32})
    model.load_state_dict(state_dict_from_jax(variables, model))
    return model.eval()


@pytest.fixture(scope="module")
def forwards():
    """The JAX forward with an f32 and a bf16 head and the port's, on the
    same perturbed weights and ring-camera batch."""
    batch = ring_batch(0)
    jargs = [jax_preprocess(jnp.asarray(batch["imgs"]))] + [
        jnp.asarray(batch[k]) for k in ARG_KEYS]
    variables = perturb(jax.jit(_jax_model(jnp.float32).init)(
        jax.random.PRNGKey(0), *jargs), 1)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        want = jax.jit(_jax_model(jdt).apply)(variables, *jargs)
        model = _port_model(variables, tdt)
        got = model(preprocess_images(t["imgs"]), *[t[k] for k in ARG_KEYS])
        out[name] = (jax.tree_util.tree_map(np.asarray, want), got, model)
    return out


def test_bf16_head_keeps_f32_parameters_and_outputs(forwards):
    _, got, model = forwards["bf16"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for k in ("all_cls_scores", "all_bbox_preds"):
        assert got[k].dtype == torch.float32, k
        assert torch.isfinite(got[k]).all(), k


@pytest.mark.parametrize("key", ["all_cls_scores", "all_bbox_preds"])
def test_bf16_head_tracks_the_jax_bf16_head(forwards, key):
    want16, got16, _ = forwards["bf16"]
    want32, got32, _ = forwards["f32"]
    d_port = np.abs(got16[key].numpy() - want16[key]).max()
    d_jax = np.abs(want16[key] - want32[key]).max()
    assert 0.0 < d_jax and d_port <= d_jax, (d_port, d_jax)
    tol = 1e-3 if key == "all_cls_scores" else 2e-3
    np.testing.assert_allclose(got32[key].numpy(), want32[key], rtol=tol,
                               atol=tol)


# --- one train step -----------------------------------------------------------

@pytest.fixture(scope="module")
def train_pair():
    mp = pytest.MonkeyPatch()
    try:
        yield _run_step_pair(mp, "bfloat16")
    finally:
        mp.undo()


def test_bf16_head_train_step_matches_jax(train_pair):
    variables, (new_state, want_m), model, opt, got_m = train_pair
    keys = {k for k in want_m if not k.startswith("_")}
    assert keys == set(got_m), sorted(keys ^ set(got_m))
    for k in sorted(keys - {"grad_norm"}):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=3e-2)
    want = {n: w.numpy().astype(np.float64) for n, w in grads_from_jax(
        new_state.opt_state[1], model).items()}
    unclip = _unclip(got_m)
    top = max(np.abs(w).max() for w in want.values())
    num = den = 0.0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p).all(), name
        g = p.grad.numpy().astype(np.float64) * unclip
        w = want[name]
        num, den = num + ((g - w) ** 2).sum(), den + (w ** 2).sum()
        if np.abs(w).max() < 1e-6 * top:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * top,
                                       err_msg=name)
            continue
        cos = g.ravel() @ w.ravel() / np.linalg.norm(g) / np.linalg.norm(w)
        assert cos > 0.95, (name, cos)
    assert np.sqrt(num / den) < 0.12


# --- remat policies, the B-stream and offline paths ----------------------------

@pytest.fixture(scope="module")
def full_bf16():
    with pytest.MonkeyPatch.context() as mp:
        return step_with("full", mp, head_dtype=torch.bfloat16)


@pytest.mark.parametrize("policy", sorted(set(port_decoder.REMAT_POLICIES)
                                          - {"full"}))
def test_bf16_head_remat_policies_give_full_gradients(policy, full_bf16,
                                                      monkeypatch):
    metrics, grads, _ = step_with(policy, monkeypatch,
                                  head_dtype=torch.bfloat16)
    want_metrics, want, _ = full_bf16
    for k, v in want_metrics.items():
        assert torch.equal(metrics[k], v), k
    for name, g in want.items():
        assert torch.equal(grads[name], g), name


def test_bf16_head_streams_and_offline():
    """B = 1 `step_batch` gives `step()`'s outputs bit for bit; the offline
    forward on the last window gives the streaming step's head outputs
    within bf16 rounding (the trunk's batch differs: one frame against
    the window)."""
    model = RaCFormer(**{**TINY, "embed_dims": 64}, trunk_dtype=torch.float32,
                      head_dtype=torch.bfloat16,
                      decoder={"gather_dtype": torch.float32})
    random_init_(model, torch.Generator().manual_seed(1)).eval()
    frames = [frame(20, 0.0), frame(21, 0.5)]
    single, batched = StreamingEvaluator(model), StreamingEvaluator(model)
    for t, f in enumerate(frames):
        want = single.step(f)
        got = batched.step_batch([f], [t == 0])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    feat_cat, lss, radar, l2i, ts = single.cache
    streamed = model.decode_window(feat_cat, lss, radar, l2i, ts[:, :1] - ts)
    window = frames[::-1]  # newest first, as the cache holds them
    stack = lambda k: torch.from_numpy(np.stack([f[k] for f in window]))[None]
    args = [stack(k) for k in FIELDS]
    offline = model(preprocess_images(args[0].float()), *args[1:],
                    ts[:, :1] - ts)
    for k in ("all_cls_scores", "all_bbox_preds"):
        assert offline[k].dtype == torch.float32
        np.testing.assert_allclose(offline[k].numpy(), streamed[k].numpy(),
                                   rtol=0.05, atol=0.05, err_msg=k)


# --- the radar temporal encoder (a repair) -------------------------------------

def _encoder_state(params):
    """The port module's state dict from the flax module's parameters."""
    names = {"downsample": "downsample", "upsample.1": "up_conv",
             "temporal_fusion": "temporal_fusion",
             "convGRU.convGRUCell.gates_conv": "gru/cell/gates",
             "convGRU.convGRUCell.matching_layer": "gru/cell/matching"}
    sd = {}
    for src, dst in names.items():
        node = params
        for part in dst.split("/"):
            node = node[part]
        sd[f"{src}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(node["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"{src}.bias"] = torch.from_numpy(np.asarray(node["bias"]).copy())
    return sd


def test_temporal_encoder_at_four_frames_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 16, 16, 64)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jm = JaxEncoder(embed_dims=64, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    loss = lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * w)
    grads = jax.jit(jax.grad(loss))(params)
    model = RadarBEVTemporalEncoder(64)
    model.load_state_dict(_encoder_state(params))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    (got * torch.from_numpy(w)).sum().backward()
    for src, g in _encoder_state(grads).items():
        p = dict(model.named_parameters())[src]
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4 * np.abs(g.numpy()).max(),
                                   err_msg=src)


# --- the config fields -------------------------------------------------------

def test_config_kwargs_takes_every_jax_field():
    """Every field of the JAX `RaCFormer` (read from the module, so a field
    added there fails here) but `train_mode` is a field the port takes,
    and the port takes no other."""
    jax_fields = {f.name for f in dataclasses.fields(JaxRaCFormer)
                  if f.name not in ("parent", "name")}
    assert set(CONFIG_FIELDS) == jax_fields - {"train_mode"}
    cfg = Config.fromfile(str(FLAGSHIP)).merge_override(["model.train_mode=True"])
    with pytest.raises(ValueError, match="train_mode"):
        config_kwargs(cfg)


def test_config_kwargs_on_head_overrides():
    cfg = Config.fromfile(str(FLAGSHIP)).merge_override(OVERRIDES)
    kwargs = config_kwargs(cfg)
    assert kwargs["head_dtype"] is torch.bfloat16
    assert kwargs["trunk_dtype"] is torch.float32
    assert kwargs["num_decoder_layers"] == 2
    assert kwargs["fused_gather"] is False
    with torch.device("meta"):
        model = RaCFormer(**kwargs)
    decoder = model.pts_bbox_head.transformer.decoder
    # the config's decoder block sets num_layers = 6, which wins over the
    # model field, as in the JAX RaCFormer
    assert decoder.num_layers == 6 and decoder.fused_gather is False
    assert decoder.decoder_layer.norm1.compute_dtype is torch.bfloat16
    assert decoder.decoder_layer.self_attn.gen_tau.compute_dtype is torch.float32
    assert model.img_backbone.dtype is torch.float32
    for value, want in (("FALSE", False), ("True", True), (None, None)):
        cfg["model"]["fused_gather"] = value
        assert config_kwargs(cfg)["fused_gather"] is want
    for field, value in (("head_dtype", "bf16"), ("trunk_dtype", 16),
                         ("fused_gather", "off")):
        bad = Config.fromfile(str(FLAGSHIP))
        bad["model"][field] = value
        with pytest.raises(ValueError, match=field):
            config_kwargs(bad)


def test_eval_driver_under_head_overrides(capsys):
    preds, metrics = eval_driver.main([
        "--config", str(FLAGSHIP), "--device", "cpu", "--synthetic",
        "--max-samples", "2", "--override", *DRIVER_TINY, *OVERRIDES,
        "decoder.num_layers=2"])
    assert len(preds) == 2 and "NDS" in metrics
    assert "eval: 2 samples" in capsys.readouterr().out


def test_train_driver_under_head_overrides(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = train_driver.main([
            "--config", str(FLAGSHIP), "--device", "cpu", "--synthetic",
            "--max-steps", "1", "--work-dir", str(tmp_path), "--override",
            *DRIVER_TINY, *OVERRIDES, "decoder.num_layers=2",
            "synthetic_samples=2", "evaluation.interval=0"])
    assert result["last_step"] == 1
    assert np.isfinite(result["metrics"][-1]["grad_norm"])
