"""The port's training checkpoints (`racformer_tpu_torch/train/checkpoint.py`)
with the behaviours `tests/test_checkpoint.py` holds the JAX package's to:
a bit-for-bit round trip of the model (parameters and BatchNorm
statistics), AdamW's moments, the update count and the EMA; rotation to
`max_keep`; a re-write after a corrupted first write; both layouts (with and
without an EMA) restored either way; `restore_latest_eval` with and without
the EMA. Also the pretrained-weight path (`apply_revise_keys`,
`load_pretrained`) against the JAX package's on one fabricated pickle, and
the converter of JAX checkpoints, `scripts/jax_checkpoint_to_torch.py`,
whose output the port evaluates as JAX does (the slice tests' tolerances).
"""

import os
import pathlib
import pickle
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.tools import convert_weights as jconvert
from racformer_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from racformer_tpu.train.step import TrainState

from racformer_tpu_torch.eval import __main__ as eval_driver
from racformer_tpu_torch.model import RaCFormer, preprocess_images, random_init_
from racformer_tpu_torch.tools.convert_weights import (apply_revise_keys,
                                                       load_pretrained,
                                                       state_dict_from_jax)
from racformer_tpu_torch.train import Optimizer, checkpoint
from racformer_tpu_torch.train.checkpoint import CheckpointManager, tree_digest
from racformer_tpu_torch.train.hooks import ema_init, ema_update

from tests.test_torch_slice import TINY, perturb, ring_batch

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "racformer_tpu" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
ARG_KEYS = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
            "lidar2img", "img2lidar", "time_diff")


class Net(torch.nn.Module):
    """A conv, a train-mode BatchNorm and a linear layer."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.bn = torch.nn.BatchNorm2d(4)
        self.fc = torch.nn.Linear(4, 2)

    def forward(self, x):
        return self.fc(self.bn(self.conv(x)).mean((2, 3)))


def trained(seed, steps=2, ema=True):
    """A Net after `steps` AdamW updates (moments, count and running
    statistics all non-trivial), with its EMA."""
    torch.manual_seed(seed)
    net = Net()
    opt = Optimizer(net.named_parameters(), total_steps=10, warmup_steps=1)
    avg = ema_init(net) if ema else None
    for s in range(steps):
        opt.zero_grad()
        net(torch.randn(2, 3, 6, 6)).square().sum().backward()
        opt.step()
        if avg is not None:
            ema_update(avg, opt.params, s + 1000)
    return net, opt, avg


def fresh(ema=True):
    torch.manual_seed(99)
    net = Net()
    opt = Optimizer(net.named_parameters(), total_steps=10, warmup_steps=1)
    return net, opt, ema_init(net) if ema else None


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_round_trip_is_bitwise(tmp_path):
    net, opt, ema = trained(0)
    mgr = CheckpointManager(str(tmp_path))
    info = mgr.save(2, net, opt, ema=ema)
    assert info["verified"] and info["attempts"] == 1 and info["bytes"] > 0
    assert os.path.isfile(tmp_path / "checkpoints" / "2" / "state.pth")

    net2, opt2, ema2 = fresh()
    assert CheckpointManager(str(tmp_path)).restore_latest(net2, opt2,
                                                           ema2) == 2
    assert_same(net2.state_dict(), net.state_dict())  # BN buffers included
    assert_same(ema2, ema)
    assert opt2.count == opt.count == 2
    for p, q in zip(net.parameters(), net2.parameters()):
        sa, sb = opt.adamw.state[p], opt2.adamw.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k
    assert tree_digest(checkpoint.snapshot(2, net2, opt2, ema2)) == info["digest"]

    # the restored run continues exactly as the original one
    for model, o in ((net, opt), (net2, opt2)):
        o.zero_grad()
        torch.manual_seed(5)
        model(torch.randn(2, 3, 6, 6)).square().sum().backward()
        o.step()
    assert_same(net2.state_dict(), net.state_dict())


def test_rotation_keeps_the_newest(tmp_path):
    net, opt, _ = trained(1, ema=False)
    mgr = CheckpointManager(str(tmp_path), max_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, net, opt)
    assert checkpoint.checkpoint_steps(str(tmp_path)) == [3, 4]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["3", "4"]
    assert mgr.latest_step() == 4


def test_verify_rewrites_a_corrupted_first_write(tmp_path, monkeypatch):
    net, opt, ema = trained(2)
    writes = []
    write = checkpoint._write

    def corrupting(state, path):
        write(state, path)
        writes.append(path)
        if len(writes) == 1:  # flip bytes deep in the first file
            with open(path, "r+b") as f:
                f.seek(os.path.getsize(path) // 2)
                f.write(b"\xff" * 64)

    monkeypatch.setattr(checkpoint, "_write", corrupting)
    info = CheckpointManager(str(tmp_path)).save(3, net, opt, ema=ema)
    assert info["attempts"] == 2 and info["verified"] and len(writes) == 2
    net2, opt2, ema2 = fresh()
    CheckpointManager(str(tmp_path)).restore_latest(net2, opt2, ema2)
    assert_same(net2.state_dict(), net.state_dict())

    monkeypatch.setattr(checkpoint, "_read", lambda path: {})
    with pytest.raises(RuntimeError, match="verification failed"):
        CheckpointManager(str(tmp_path / "bad"), retries=2).save(1, net, opt)
    assert checkpoint.checkpoint_steps(str(tmp_path / "bad")) == []


def test_both_layouts_restore_either_way(tmp_path):
    # saved without an EMA, resumed with one: the EMA starts as the weights
    net, opt, _ = trained(3, ema=False)
    CheckpointManager(str(tmp_path / "plain")).save(2, net, opt)
    net2, opt2, ema2 = fresh()
    assert CheckpointManager(str(tmp_path / "plain")).restore_latest(
        net2, opt2, ema2) == 2
    assert_same(ema2, {n: p.detach() for n, p in net.named_parameters()})
    # saved with an EMA, resumed without: the EMA is ignored
    net, opt, ema = trained(4)
    CheckpointManager(str(tmp_path / "ema")).save(2, net, opt, ema=ema)
    net3, opt3, _ = fresh(ema=False)
    assert CheckpointManager(str(tmp_path / "ema")).restore_latest(
        net3, opt3) == 2
    assert_same(net3.state_dict(), net.state_dict())
    assert opt3.count == 2
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        net3, opt3) is None


def test_restore_latest_eval(tmp_path):
    net, opt, ema = trained(5)
    CheckpointManager(str(tmp_path)).save(7, net, opt, ema=ema)
    mgr = CheckpointManager(str(tmp_path), verify=False)
    plain, with_ema = Net(), Net()
    assert mgr.restore_latest_eval(plain) == 7
    assert_same(plain.state_dict(), net.state_dict())
    assert mgr.restore_latest_eval(with_ema, use_ema=True) == 7
    assert_same(dict(with_ema.named_parameters()), ema)
    assert torch.equal(with_ema.bn.running_mean, net.bn.running_mean)
    assert not torch.equal(with_ema.fc.weight, net.fc.weight)

    net, opt, _ = trained(6, ema=False)
    CheckpointManager(str(tmp_path / "plain")).save(1, net, opt)
    with pytest.raises(ValueError, match="EMA"):
        CheckpointManager(str(tmp_path / "plain")).restore_latest_eval(
            Net(), use_ema=True)


# --- pretrained weights -----------------------------------------------------

def _jax_template(jmodel, batch):
    jargs = [jax_preprocess(jnp.asarray(batch["imgs"]))] + [
        jnp.asarray(batch[k]) for k in ARG_KEYS]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *jargs)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_revise_keys_and_load_pretrained_match_jax(tmp_path, capsys):
    """One pickle of mmdet-named tensors: the stem conv under `backbone.`
    (renamed by revise_keys), a stem BatchNorm scale, a key no model has,
    and a stem conv of the wrong shape under another name. The port loads
    the same tensors as the JAX package, bit for bit, and counts the same
    keys as not converted."""
    rng = np.random.default_rng(0)
    sd = {"backbone.conv1.weight": rng.normal(size=(64, 3, 7, 7)).astype("float32"),
          "backbone.bn1.weight": rng.normal(size=(64,)).astype("float32"),
          "backbone.no_such.weight": np.ones((3,), np.float32),
          "img_backbone.layer1.0.conv1.weight": np.ones((5, 5, 1, 1), np.float32)}
    revise = [("backbone", "img_backbone")]
    assert list(apply_revise_keys(sd, revise)) == list(
        jconvert.apply_revise_keys(sd, revise))
    path = tmp_path / "pre.pkl"
    with open(path, "wb") as f:
        pickle.dump(sd, f)

    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32, train_mode=False)
    params = jconvert.load_pretrained(str(path), _jax_template(
        jmodel, ring_batch(0))["params"], revise)
    jax_out = capsys.readouterr().out

    model = RaCFormer(**TINY, trunk_dtype=torch.float32)
    random_init_(model, torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrained(str(path), model, revise) is model
    port_out = capsys.readouterr().out
    count = lambda out: out.split("] ")[-1].split(" keys")[0]
    assert count(port_out) == count(jax_out) == "2"

    want = state_dict_from_jax({"params": params}, model, keys={
        "img_backbone.conv1.weight", "img_backbone.bn1.weight"})
    changed = {k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])}
    assert changed == set(want)
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k


# --- the JAX checkpoint converter -----------------------------------------

CONVERT_OVERRIDES = [
    "model.num_cams=2", "model.num_frames=2", "model.num_query=12",
    "model.num_clusters=2", "model.image_hw=(64,128)", "model.depth_bins=16",
    "model.bev_size=(32,32)", "decoder.num_layers=2", "radar.max_points=64"]


def test_converter_output_evaluates_as_jax(tmp_path):
    """A JAX work dir (orbax, with an EMA) converted by
    `scripts/jax_checkpoint_to_torch.py`: the port restores it through
    `restore_latest_eval`, and its head outputs on one window equal the JAX
    package's from the same checkpoint (1e-3 / 2e-3, the slice tests'); the
    EMA arrives in the port's layout; the eval driver reads the directory."""
    batch = ring_batch(0)
    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32,
                          decoder={"gather_dtype": jnp.float32},
                          fused_gather=False, train_mode=False)
    variables = perturb(_jax_template(jmodel, batch), 1)
    ema = perturb(variables, 2)["params"]
    state = TrainState(variables["params"], variables["batch_stats"],
                       jnp.zeros(()), jnp.asarray(3, jnp.int32))
    JaxCheckpointManager(str(tmp_path / "jax"), verify=False).save(
        3, state, ema=ema)

    script = runpy.run_path(str(REPO / "scripts" / "jax_checkpoint_to_torch.py"))
    script["main"](["--config", str(CONFIG), str(tmp_path / "jax"),
                    str(tmp_path / "port"), "--ema", "--override",
                    *CONVERT_OVERRIDES])

    model = RaCFormer(**TINY, trunk_dtype=torch.float32,
                      decoder={"gather_dtype": torch.float32})
    mgr = CheckpointManager(str(tmp_path / "port"), verify=False)
    assert mgr.restore_latest_eval(model) == 3
    model.eval()
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    got = model(preprocess_images(tb["imgs"]), *[tb[k] for k in ARG_KEYS])
    jargs = [jax_preprocess(jnp.asarray(batch["imgs"]))] + [
        jnp.asarray(batch[k]) for k in ARG_KEYS]
    want = jax.jit(jmodel.apply)(variables, *jargs)
    for k in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=2e-3, err_msg=k)

    ema_model = RaCFormer(**TINY, trunk_dtype=torch.float32)
    mgr.restore_latest_eval(ema_model, use_ema=True)
    names = {n for n, _ in ema_model.named_parameters()}
    want_ema = state_dict_from_jax({"params": ema}, ema_model, keys=names)
    for n, p in ema_model.named_parameters():
        assert torch.equal(p.detach(), want_ema[n]), n

    by_driver = RaCFormer(**TINY, trunk_dtype=torch.float32)
    assert eval_driver.load_checkpoint(by_driver, str(tmp_path / "port"),
                                       "v1.0.0") == "v1.0.0"
    for k, v in model.state_dict().items():
        assert torch.equal(by_driver.state_dict()[k], v), k
