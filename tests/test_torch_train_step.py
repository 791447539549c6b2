"""One whole training step of the PyTorch port against the JAX package's
`make_train_step`, and the decoder's dropout under activation checkpointing.

The step runs at a tiny config (2 cameras, 2 frames, 64x128 images, 32^2
BEV, 2 decoder layers, max_gt 4, embed_dims 256 so the JAX samplers take
their custom VJP, float32 everywhere) with a batch of 2 split into 2
microbatches, from the same perturbed weights (`tests/test_torch_slice.py`).
The JAX side runs kernels K2-K4 as its Pallas kernels in interpret mode
(`decoder=dict(bev_pallas=True, img_pallas=True)`); the port runs their
plain versions.

The random draws are made equal without editing the JAX package: dropout
is off in the port (no dropout seed) and the flax `Dropout` is the identity
under a test-local monkeypatch; the augmentation draws are re-derived from
the JAX step's keys; the query-denoising draws are fixed numpy arrays, fed
to the port and, through a test-local monkeypatch of
`RaCFormerHead._dn_prepare`, to the JAX head (both microbatches get the same
ones). The JAX optimizer is built with the recipe's frozen set (stem and
layer1, see `test_param_labels` in `tests/test_torch_train_parts.py`).

The images are coarse blocks of random colour (2x4 blocks) under 30%
pixel noise, so that the 4 images of a microbatch differ in their global
statistics: on images of pure noise the DepthNet's ASPP pooling branch
normalizes 4 nearly equal values per channel in train mode, which
magnifies rounding noise about 650 times in the forward pass, and
gradients of 211 of the 357 parameter tensors then differ from JAX's by
more than 1e-3 of their max (up to 10%), on both sides alike (a 1e-7
weight scaling moves the port's by as much).

Tolerances: losses 1e-4 relative. Each gradient to 1e-3 of its tensor's
max |value| (sums in another order through two microbatches), but for the
tensors in `LOOSE`, held to 5e-3 (see there), and a gradient that is zero
but for rounding, held to 1e-6 of the largest gradient. Every gradient
must also point the same way as JAX's (cosine similarity above 0.999; a
sign or corner-order slip in a kernel's backward fails this by far). grad_norm
5e-4 relative: it sums the squares of those gradients, and JAX's differs
from the port's by 2.3e-4 on this config. Updated BatchNorm statistics
1e-4. Updated parameters within 2 lr of each other (a first AdamW step
moves an element by lr * sign(g), so an element whose gradient lies inside
the tolerance may move either way), and by the same amount, to 5% of lr,
where the gradient lies outside it.
"""

import runpy
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.nn import head as jhead
from racformer_tpu.ops.bbox_codec import encode_bbox, xy_to_theta_d
from racformer_tpu.train import optim as joptim
from racformer_tpu.train.step import TrainState, make_train_step as jax_train_step

from racformer_tpu_torch.model import RaCFormer, preprocess_images, random_init_
from racformer_tpu_torch.nn.head import dn_draws
from racformer_tpu_torch.nn.layers import DropoutRNG, dropout_rng
from racformer_tpu_torch.tools.convert_weights import (grads_from_jax,
                                                       state_dict_from_jax)
from racformer_tpu_torch.train import Optimizer, make_train_step
from racformer_tpu_torch.train import __main__ as driver

from tests.test_torch_slice import TINY, perturb, ring_batch
from tests.test_torch_train_parts import _jax_grid_draws, _jax_photo_draws

B, G, A = 2, 4, 2
CONFIG = (Path(__file__).resolve().parents[1] / "racformer_tpu_torch" / "configs"
          / "racformer_r50_nuimg_704x256_f8.py")
DEPTH = dict(d_lo=1.0, d_hi=65.0, num_bins=16, downsample=16)
TOTAL_STEPS = 1000
_JAX_LABEL = joptim._param_label
_DEC = "pts_bbox_head.transformer.decoder.decoder_layer."
# gradients held to 5e-3 of their max, with the error measured on this
# config (of max): the image sampler's location gradients, which change
# by a whole corner difference for a point whose coordinate JAX and the
# port round to either side of a pixel edge (bilinear interpolation's
# gradient jumps there), and the position encoder's bias, whose error is
# as far above its weight-scaling spread as theirs ...
LOOSE = {_DEC + "sampling.ray_points_offset.weight": 3.4e-3,
         _DEC + "sampling.ray_points_offset.bias": 3.2e-3,
         _DEC + "sampling.sampling_offset.weight": 1.2e-3,
         _DEC + "sampling.sampling_offset.bias": 1.3e-3,
         _DEC + "position_encoder.0.bias": 1.8e-3,
         # ... and gradients that a 1e-7 scaling of every weight moves by
         # 2-3e-3 of their max in the port alone (they reach the DepthNet's
         # train-mode BatchNorm layers and the image sampler through the
         # features)
         "img_backbone.layer4.1.conv3.weight": 2.2e-3,
         "img_backbone.layer4.1.bn3.bias": 1.8e-3,
         "img_backbone.layer4.2.conv3.weight": 2.3e-3,
         "img_backbone.layer4.2.bn3.bias": 2.0e-3,
         _DEC + "ffn.layers.0.0.weight": 1.9e-3,
         _DEC + "ffn.layers.0.0.bias": 1.7e-3}


def _batch(seed):
    rng = np.random.default_rng(seed)
    batch = ring_batch(seed, B=B)
    blocks = np.random.default_rng(seed + 5).uniform(
        0, 255, batch["imgs"].shape[:3] + (2, 4, 3))
    batch["imgs"] = (0.7 * blocks.repeat(32, axis=3).repeat(32, axis=4)
                     + 0.3 * batch["imgs"]).astype(np.float32)
    boxes = np.zeros((B, G, 9), np.float32)
    boxes[..., 0:2] = rng.uniform(-20, 20, (B, G, 2))
    boxes[..., 2] = rng.uniform(-2, 1, (B, G))
    boxes[..., 3:6] = rng.uniform(0.5, 5, (B, G, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    boxes[..., 7:9] = rng.normal(size=(B, G, 2))
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    boxes[~mask] = 0.0
    batch.update(
        gt_bboxes=boxes, gt_mask=mask,
        gt_labels=np.where(mask, rng.integers(0, 10, (B, G)), 0).astype(np.int32),
        gt_depth=(rng.uniform(2, 60, (B, 2, 64, 128))
                  * (rng.uniform(size=(B, 2, 64, 128)) < 0.1)).astype(np.float32))
    return batch


def _fixed_dn_prepare(draws):
    """`RaCFormerHead._dn_prepare` with the draws given (the JAX body with
    its three random calls replaced)."""
    rand, flip, rand_lab = (np.asarray(draws[k]) for k in ("rand", "flip",
                                                           "rand_lab"))

    def prepare(self, gt_bboxes, gt_labels, gt_mask):
        Bm, Gm, _ = gt_bboxes.shape
        ng = self.dn_groups
        wlh = gt_bboxes[..., 3:6]
        enc = xy_to_theta_d(encode_bbox(gt_bboxes, self.pc_range))
        e = jnp.broadcast_to(enc[:, None], (Bm, ng, Gm, enc.shape[-1]))
        w2 = jnp.broadcast_to(wlh[:, None], (Bm, ng, Gm, 3))
        r = 65.0
        diag = jnp.sqrt(w2[..., 0:1] ** 2 + w2[..., 1:2] ** 2)
        arc = diag / (2.0 * jnp.pi * jnp.maximum(e[..., 1:2], 1e-4) * r)
        s = self.dn_bbox_noise_scale
        theta = e[..., 0:1] + rand[..., 0:1] * (arc / 2.0) * s * e[..., 1:2]
        theta = jnp.mod((theta + 1.0) * 2.0 * jnp.pi, 2.0 * jnp.pi) / (2.0 * jnp.pi)
        noised = jnp.concatenate(
            [theta, e[..., 1:2] + rand[..., 1:2] * diag / (r * 2.0) * s,
             e[..., 2:3] + rand[..., 2:3] * w2[..., 2:3] / 16.0 * s, e[..., 3:]],
            axis=-1)
        noised = noised.at[..., 0:3].set(jnp.clip(noised[..., 0:3], 0.0, 1.0))
        labels = jnp.broadcast_to(gt_labels[:, None], (Bm, ng, Gm))
        labels = jnp.where(flip, rand_lab, labels)
        valid = jnp.broadcast_to(gt_mask[:, None], (Bm, ng, Gm))
        S = ng * Gm
        noised = jnp.where(valid[..., None], noised, 0.0).reshape(Bm, S, -1)
        labels = jnp.where(valid, labels, self.num_classes).reshape(Bm, S)
        return noised, labels, valid.reshape(Bm, S)

    return prepare


def _recipe_label(path):
    """The recipe's frozen set (stem + layer1) on flax paths."""
    keys = [str(getattr(p, "key", p)) for p in path]
    if keys[0] == "img_backbone" and keys[1].startswith(("conv1", "bn1",
                                                         "layer1_")):
        return "frozen"
    return _JAX_LABEL(path) if keys[0] != "img_backbone" else "backbone"


def _capturing(tx):
    """`tx` that also keeps the gradients it was given in its state."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _unclip(metrics, clip=35.0):
    """The factor the optimizer scaled the gradients by, inverted."""
    return max(1.0, float(metrics["grad_norm"]) / clip)


def _port_step(variables, batch, draws):
    """One port train step from the JAX variables; returns (model,
    optimizer, metrics)."""
    model = RaCFormer(**TINY, trunk_dtype=torch.float32, max_gt=G,
                      decoder={"gather_dtype": torch.float32})
    model.load_state_dict(state_dict_from_jax(variables, model))
    opt = Optimizer(model.named_parameters(), total_steps=TOTAL_STEPS)
    train_step = make_train_step(model, opt, DEPTH, accum_steps=A)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return model, opt, train_step(tb, draws=draws)


@pytest.fixture(scope="module")
def step_pair():
    mp = pytest.MonkeyPatch()
    try:
        yield _run_step_pair(mp)
    finally:
        mp.undo()


def _run_step_pair(mp):
    batch = _batch(0)
    gen = torch.Generator().manual_seed(3)
    dn = dn_draws(1, G, 10, 10, gen)
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mp.setattr(jhead.RaCFormerHead, "_dn_prepare", _fixed_dn_prepare(dn))
    mp.setattr(joptim, "_param_label", _recipe_label)

    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32, max_gt=G,
                          decoder={"gather_dtype": jnp.float32,
                                   "bev_pallas": True, "img_pallas": True},
                          train_mode=True)
    keys = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
            "lidar2img", "img2lidar", "time_diff")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init_args = [jax_preprocess(jb["imgs"])] + [jb[k] for k in keys]
    rngs = {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    variables = perturb(jax.jit(jmodel.init)(
        rngs, *init_args, gt_bboxes=jb["gt_bboxes"], gt_labels=jb["gt_labels"],
        gt_mask=jb["gt_mask"]), 1)
    tx, sched = joptim.make_optimizer(variables["params"],
                                      total_steps=TOTAL_STEPS)
    tx = _capturing(tx)
    state = TrainState(variables["params"], variables["batch_stats"],
                       tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(jax_train_step(jmodel, tx, depth_cfg=DEPTH, accum_steps=A))
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, jb, rng, 2.0)
    jax_out = jax.tree_util.tree_map(np.asarray, (new_state, metrics))

    # the port, from the same weights, with the same draws
    mkeys = jax.random.split(rng, A)
    draws = [{"photo": _jax_photo_draws(jax.random.fold_in(k, 2), 1),
              "grid": _jax_grid_draws(jax.random.fold_in(k, 3), 64),
              "dn": dn, "dropout_seed": None} for k in mkeys]
    assert any(d["grid"]["apply"] for d in draws)
    model, opt, port_metrics = _port_step(variables, batch, draws)
    return variables, jax_out, model, opt, port_metrics


def _grad_bounds(want):
    """Each gradient's tolerance; a gradient that is zero but for rounding
    (a conv bias before a train-mode BatchNorm, below 1e-6 of the largest
    gradient) is held to that 1e-6."""
    top = max(np.abs(w).max() for w in want.values())
    bounds = {}
    for n, w in want.items():
        m = np.abs(w).max()
        bounds[n] = (1e-6 * top if m < 1e-6 * top
                     else (5e-3 if n in LOOSE else 1e-3) * m)
    return bounds


def test_losses_and_grad_norm_match_jax(step_pair):
    _, (_, want), _, _, got = step_pair
    keys = {k for k in want if not k.startswith("_")}
    assert keys == set(got), sorted(keys ^ set(got))
    assert {"loss_cls_dn", "loss_bbox_dn", "d0.loss_cls", "loss_depth"} <= keys
    for k in sorted(keys - {"grad_norm"}):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=5e-4)
    assert np.isfinite(float(got["loss_total"]))


def test_every_gradient_matches_jax(step_pair):
    _, (new_state, _), model, _, got = step_pair
    want = {n: w.numpy() for n, w in grads_from_jax(new_state.opt_state[1],
                                                    model).items()}
    bounds = _grad_bounds(want)
    assert LOOSE.keys() <= want.keys(), sorted(LOOSE.keys() - want.keys())
    unclip = _unclip(got)  # the optimizer clipped the port's in place
    missing = []
    for name, p in model.named_parameters():
        if p.grad is None:
            missing.append(name)
            continue
        np.testing.assert_allclose(p.grad.numpy() * unclip, want[name], rtol=0,
                                   atol=bounds[name], err_msg=name)
    assert not missing, missing
    top = max(np.abs(w).max() for w in want.values())
    for name, p in model.named_parameters():
        w = want[name].astype(np.float64).ravel()
        if np.abs(w).max() < 1e-6 * top:
            continue  # zero but for rounding (a conv bias before BatchNorm)
        g = p.grad.numpy().astype(np.float64).ravel()
        cos = g @ w / np.linalg.norm(g) / np.linalg.norm(w)
        assert cos > 0.999, (name, cos)
    # the sampling offsets get location gradients (K4's d_wx / d_wy)
    for site in ("sampling", "sampling_radar_bev", "sampling_lss_bev"):
        assert np.abs(want[_DEC + site + ".sampling_offset.weight"]).max() > 0


def test_updated_params_and_batch_stats_match_jax(step_pair):
    variables, (new_state, _), model, opt, _ = step_pair
    want = state_dict_from_jax({"params": new_state.params,
                                "batch_stats": new_state.batch_stats}, model)
    before = state_dict_from_jax(variables, model)
    grads = {n: w.numpy() for n, w in grads_from_jax(new_state.opt_state[1],
                                                     model).items()}
    bounds = _grad_bounds(grads)
    lr = opt.lr(step=0)
    params = dict(model.named_parameters())
    for name, t in model.state_dict().items():
        w, got = want[name].numpy(), t.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        elif name in params:
            np.testing.assert_allclose(got, w, rtol=0, atol=2.05 * lr,
                                       err_msg=name)
            big = np.abs(grads[name]) > bounds[name]
            step_got = got - before[name].numpy()
            step_want = w - before[name].numpy()
            np.testing.assert_allclose(step_got[big], step_want[big], rtol=0,
                                       atol=0.05 * lr, err_msg=name)
    for name, p in opt.frozen().items():
        np.testing.assert_array_equal(p.detach().numpy(), before[name].numpy())
    assert len(opt.frozen()) > 0


def test_dropout_masks_survive_checkpointing():
    """The decoder's iterations are checkpointed in train mode; their
    dropout masks come from a seed drawn before each checkpointed call, so
    the backward's recompute uses the forward's masks: the gradients with
    and without checkpointing are the same, and differ from those with
    dropout off."""
    batch = _batch(1)
    model = RaCFormer(**TINY, trunk_dtype=torch.float32, max_gt=G,
                      decoder={"gather_dtype": torch.float32})
    random_init_(model, torch.Generator().manual_seed(0)).train()
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    dn = dn_draws(B, G, 10, 10, torch.Generator().manual_seed(1))
    decoder = model.pts_bbox_head.transformer.decoder
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def grads(remat, seed):
        model.load_state_dict(state)  # undo the BatchNorm statistics update
        model.zero_grad()
        decoder.remat = remat
        with dropout_rng(None if seed is None else DropoutRNG(seed, "cpu")):
            outs = model(preprocess_images(tb["imgs"]), *[tb[k] for k in (
                "radar_points", "radar_mask", "radar_depth", "radar_rcs",
                "lidar2img", "img2lidar", "time_diff")],
                gt_bboxes=tb["gt_bboxes"], gt_labels=tb["gt_labels"],
                gt_mask=tb["gt_mask"], dn=dn)
        loss = sum((v.float() ** 2).mean() for k, v in outs.items()
                   if k != "dn_valid")
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    with_remat, without, off = grads(True, 5), grads(False, 5), grads(True, None)
    decoder.remat = True
    assert with_remat.keys() == without.keys()
    for n in with_remat:
        torch.testing.assert_close(with_remat[n], without[n], rtol=1e-5,
                                   atol=1e-7, msg=n)
    ffn = "pts_bbox_head.transformer.decoder.decoder_layer.ffn.layers.1.weight"
    assert not torch.allclose(with_remat[ffn], off[ffn])


def _tiny_config():
    """The flagship config file's names, with the model cut to the tiny
    config (the train driver reads them as `runpy` gives them)."""
    cfg = runpy.run_path(str(CONFIG))
    cfg["model"] = dict(cfg["model"], num_cams=2, num_frames=2, num_query=12,
                        num_clusters=2, image_hw=(64, 128), depth_bins=16,
                        bev_size=(32, 32), max_gt=G)
    cfg["decoder"] = dict(cfg["decoder"], num_layers=2,
                          d_region_list=cfg["decoder"]["d_region_list"][:2])
    cfg["depth"] = dict(cfg["depth"], num_bins=16)
    cfg["radar"] = dict(cfg["radar"], max_points=64)
    return cfg


def test_driver_builds_the_config_and_takes_a_step():
    """The train driver's `build` on a config dict: the config's batch and
    accumulation, its optimizer, a step with finite metrics that moves the
    trainable parameters and leaves the frozen ones."""
    model, opt, step, dataset, batch = driver.build(_tiny_config(), "cpu", 0,
                                                    10)
    assert (batch, len(dataset)) == (2, 64)
    assert model.training and model.pts_bbox_head.transformer.decoder.remat
    assert opt.lr(step=0) == pytest.approx(4e-4 / 3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step(driver.to_device(dataset.batch([0, 1]), "cpu"),
                   torch.Generator().manual_seed(0))
    assert {"loss_total", "grad_norm", "loss_depth"} <= metrics.keys()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    frozen = opt.frozen()
    assert frozen
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n in frozen), n


def test_driver_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        driver.main(["--config", str(CONFIG), "--synthetic", "--max-steps",
                     "1"])
