"""The port's training numerics against the JAX package at the flagship
config's full shapes (6 cameras, 8 frames, 256x704, Q = 900 + 10 DN groups
of 32, C = 256, 6 decoder iterations, D = 96, BEV 128^2): the Hungarian
targets, the polar match costs, the per-layer set losses, query denoising
and the depth loss at production geometry, as
`tests/test_train_golden.py::test_train_loss_golden_flagship_shapes` pins
the JAX package's. Both tests are `slow` (a full-size JAX compile and 48
images of 256x704 on the CPU; the card machine has no JAX).

Weights: the port's seeded random weights (`random_init_`, train mode)
carried into the JAX model by `convert_state_dict`, float32 everywhere
(trunk and sampler maps). One seeded ring-camera sample
(`tests/test_torch_slice.py::ring_batch`) with the config's 1,536 radar
points, coarse-block images as `tests/test_torch_train_step.py` feeds (on
pure noise the train-mode BatchNorm amplifies rounding), 32 valid GT boxes
and sparse GT depth (5% of the pixels, as `tests/test_train_golden.py`'s
`_make_gt_depth`). The draws are aligned as `tests/test_torch_train_step.py`
aligns them: dropout off on both sides (the flax `Dropout` is the identity
under a test-local monkeypatch), the query-denoising draws fixed numpy
arrays fed to the port and, through a monkeypatch of
`RaCFormerHead._dn_prepare`, to the JAX head. The JAX side takes its CPU
default samplers (no Pallas interpret mode at this size), as the JAX
package's goldens do.

* `test_train_losses_golden`: one train-mode forward on each side,
  no augmentation, and each package's `detection_loss` and `depth_loss`
  (the step's depth weight 2.0): every loss component within
  `test_train_golden.py`'s tolerance, rtol 2e-4 and atol 1e-5.
* `test_train_step_gradients_golden`: one whole train step on
  each side (batch 1, no accumulation, the augmentation draws re-derived
  from the JAX step's key): every loss within the same tolerance,
  grad_norm within 1e-3 relative, and every gradient tensor within cosine
  0.999 of JAX's (a tensor that is zero but for rounding, below 1e-6 of
  the largest gradient, is left out). It holds the JAX backward at full
  width, which takes far more host memory than the forward.

Each test also runs at a tiny cut of the config (`-k tiny`, ~80 s on the
CPU for both), the same code path. Run with `-m slow -s` to print each
component's relative deviation.
"""

import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.nn import head as jhead
from racformer_tpu.tools.convert_weights import convert_state_dict
from racformer_tpu.train import losses as jlosses
from racformer_tpu.train import optim as joptim
from racformer_tpu.train.step import TrainState
from racformer_tpu.train.step import make_train_step as jax_train_step

from racformer_tpu_torch.config import Config
from racformer_tpu_torch.model import (RaCFormer, config_kwargs,
                                       preprocess_images, random_init_)
from racformer_tpu_torch.nn.head import dn_draws
from racformer_tpu_torch.nn.layers import dropout_rng
from racformer_tpu_torch.tools.convert_weights import grads_from_jax
from racformer_tpu_torch.train import Optimizer, make_train_step
from racformer_tpu_torch.train import losses as port_losses

from tests.test_torch_slice import ring_batch
from tests.test_torch_train_parts import _jax_grid_draws, _jax_photo_draws
from tests.test_torch_train_step import (_capturing, _fixed_dn_prepare,
                                         _recipe_label, _unclip)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "racformer_tpu_torch" / "configs" / "racformer_r50_nuimg_704x256_f8.py"
GT = 32
RTOL, ATOL = 2e-4, 1e-5  # tests/test_train_golden.py's
MODEL_KEYS = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
              "lidar2img", "img2lidar", "time_diff")
DEPTH_KEYS = ("d_lo", "d_hi", "num_bins", "downsample")


def flagship():
    """The flagship config's model arguments (float32, 32 GT) and its
    depth block."""
    cfg = Config.fromfile(str(CONFIG))
    kwargs = config_kwargs(cfg)
    kwargs.update(max_gt=GT, trunk_dtype=torch.float32,
                  decoder={**kwargs["decoder"], "gather_dtype": torch.float32})
    depth = {k: v for k, v in dict(cfg["depth"]).items() if k in DEPTH_KEYS}
    return kwargs, depth, int(cfg["radar"]["max_points"])


def sample(kwargs, points, seed=0):
    """One ring-camera sample of the model's shapes: coarse-block images,
    `GT` valid boxes around the ego car, sparse GT depth on frame 0."""
    T, N, (H, W) = kwargs["num_frames"], kwargs["num_cams"], kwargs["image_hw"]
    rng = np.random.default_rng(seed)
    batch = ring_batch(seed, T=T, N=N, H=H, W=W, P=points)
    blocks = rng.uniform(0, 255, (1, T, N, 2, 4, 3))
    batch["imgs"] = (0.7 * blocks.repeat(H // 2, axis=3).repeat(W // 4, axis=4)
                     + 0.3 * batch["imgs"]).astype(np.float32)
    boxes = np.zeros((1, GT, 9), np.float32)
    boxes[..., 0:2] = rng.uniform(-40, 40, (1, GT, 2))
    boxes[..., 2] = rng.uniform(-2, 1, (1, GT))
    boxes[..., 3:6] = rng.uniform(0.5, 5, (1, GT, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (1, GT))
    boxes[..., 7:9] = rng.normal(size=(1, GT, 2))
    depth = rng.uniform(0.5, 70.0, (1, N, H, W)).astype(np.float32)
    batch.update(
        gt_bboxes=boxes, gt_mask=np.ones((1, GT), bool),
        gt_labels=rng.integers(0, 10, (1, GT)).astype(np.int32),
        gt_depth=np.where(rng.uniform(size=depth.shape) < 0.05, depth, 0.0)
        .astype(np.float32))
    return batch


def pair(monkeypatch, kwargs, batch):
    """The port model (seeded random weights, train mode), the fixed DN
    draws, the JAX model with dropout off and those DN draws, and the JAX
    variables converted from the port's weights."""
    model = RaCFormer(**kwargs)
    random_init_(model, torch.Generator().manual_seed(0)).train()
    head = model.pts_bbox_head
    dn = dn_draws(1, GT, head.dn_groups, head.num_classes,
                  torch.Generator().manual_seed(3))
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(jhead.RaCFormerHead, "_dn_prepare",
                        _fixed_dn_prepare(dn))
    jmodel = JaxRaCFormer(
        **{k: v for k, v in kwargs.items()
           if k not in ("decoder", "trunk_dtype", "head_dtype")},
        decoder={**kwargs["decoder"], "gather_dtype": jnp.float32},
        trunk_dtype=jnp.float32, train_mode=True)
    jargs, gt = jax_inputs(batch)
    rngs = {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda *a: jmodel.init(rngs, *a, **gt), *jargs))
    variables, unmatched = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, template,
        strict=True)
    assert unmatched == []
    return model, dn, jmodel, variables


def jax_inputs(batch):
    """The JAX model's positional inputs and its GT keywords."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = [jax_preprocess(jb["imgs"])] + [jb[k] for k in MODEL_KEYS]
    return args, {k: jb[k] for k in ("gt_bboxes", "gt_labels", "gt_mask")}


def hold_losses(got, want, tag):
    """Every loss component of `want` (JAX) in `got` (the port) within
    RTOL / ATOL; prints and returns each relative deviation."""
    keys = {k for k in want if not k.startswith("_")}
    assert keys <= set(got), sorted(keys - set(got))
    assert {"loss_cls_dn", "loss_bbox_dn", "d0.loss_cls", "loss_depth"} <= keys
    deltas = {}
    for k in sorted(keys):
        g, w = float(got[k]), float(want[k])
        deltas[k] = abs(g - w) / max(abs(w), 1e-6)
        print(f"{tag} {k}: port {g:.7g}, JAX {w:.7g}, relative deviation "
              f"{deltas[k]:.3g}")
    for k in sorted(keys):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    return deltas


def losses_golden(monkeypatch, kwargs, depth, batch):
    model, dn, jmodel, variables = pair(monkeypatch, kwargs, batch)
    jargs, gt = jax_inputs(batch)

    def jax_losses(v, gt_depth, *args, **gt):  # one program: the matching too
        outs, _ = jmodel.apply(v, *args, **gt, rngs={
            "dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
            mutable=["batch_stats"])
        losses = jlosses.detection_loss(
            outs, gt["gt_bboxes"], gt["gt_labels"], gt["gt_mask"],
            num_classes=jmodel.num_classes)
        losses["loss_depth"] = jlosses.depth_loss(
            outs["depth_logits"], gt_depth, **depth, weight=2.0)
        return losses

    want = jax.jit(jax_losses)(variables, jnp.asarray(batch["gt_depth"]),
                               *jargs, **gt)
    want = {k: float(v) for k, v in want.items()}
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    with torch.no_grad(), dropout_rng(None):
        outs = model(preprocess_images(t["imgs"]), *[t[k] for k in MODEL_KEYS],
                     gt_bboxes=t["gt_bboxes"], gt_labels=t["gt_labels"],
                     gt_mask=t["gt_mask"], dn=dn)
    got = port_losses.detection_loss(outs, t["gt_bboxes"], t["gt_labels"],
                                     t["gt_mask"], num_classes=model.num_classes)
    got["loss_depth"] = port_losses.depth_loss(
        outs["depth_logits"], t["gt_depth"], **depth, weight=2.0)
    return hold_losses(got, want, "[losses]")


def step_golden(monkeypatch, kwargs, depth, batch):
    model, dn, jmodel, variables = pair(monkeypatch, kwargs, batch)
    monkeypatch.setattr(joptim, "_param_label", _recipe_label)
    tx, _ = joptim.make_optimizer(variables["params"], total_steps=1000)
    tx = _capturing(tx)
    state = TrainState(variables["params"], variables["batch_stats"],
                       tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(jax_train_step(jmodel, tx, depth_cfg=depth))
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, metrics = step(state, jb, rng, 2.0)
    want = {k: float(v) for k, v in metrics.items() if not k.startswith("_")}
    jgrads = {n: g.numpy() for n, g in grads_from_jax(new_state.opt_state[1],
                                                      model).items()}
    del new_state, state, step
    H = kwargs["image_hw"][0]
    draws = [{"photo": _jax_photo_draws(jax.random.fold_in(rng, 2), 1),
              "grid": _jax_grid_draws(jax.random.fold_in(rng, 3), H),
              "dn": dn, "dropout_seed": None}]
    opt = Optimizer(model.named_parameters(), total_steps=1000)
    train_step = make_train_step(model, opt, depth)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    got = {k: float(v) for k, v in train_step(t, draws=draws).items()
           if not k.startswith("_")}
    deltas = hold_losses({k: v for k, v in got.items() if k != "grad_norm"},
                         {k: v for k, v in want.items() if k != "grad_norm"},
                         "[step]")
    rel = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    print(f"[step] grad_norm: port {got['grad_norm']:.7g}, JAX "
          f"{want['grad_norm']:.7g}, relative deviation {rel:.3g}")
    unclip = _unclip(got)  # the optimizer clipped the port's in place
    top = max(np.abs(w).max() for w in jgrads.values())
    cosines = {}
    for name, p in model.named_parameters():
        w = jgrads[name].astype(np.float64).ravel()
        if np.abs(w).max() < 1e-6 * top:
            continue  # zero but for rounding (a conv bias before BatchNorm)
        assert p.grad is not None, name
        g = p.grad.numpy().astype(np.float64).ravel() * unclip
        cosines[name] = float(g @ w / np.linalg.norm(g) / np.linalg.norm(w))
    worst = min(cosines, key=cosines.get)
    print(f"[step] gradients: {len(cosines)} tensors compared, smallest "
          f"cosine {cosines[worst]:.7f} ({worst})")
    assert rel <= 1e-3, (got["grad_norm"], want["grad_norm"])
    assert cosines[worst] > 0.999, (worst, cosines[worst])
    return deltas, rel, cosines


@pytest.fixture(params=["flagship", "tiny"])
def one_sample(request):
    """The flagship's model, depth block and sample; "tiny" cuts it to 2
    cameras, 2 frames of 64x128, 48 queries (more than the 32 GT), 2
    decoder layers, D = 16 and a 32^2 BEV: the same code path in ~80 s."""
    kwargs, depth, points = flagship()
    if request.param == "tiny":
        kwargs.update(num_cams=2, num_frames=2, image_hw=(64, 128),
                      depth_bins=16, bev_size=(32, 32), num_query=48,
                      num_clusters=2,
                      decoder={**kwargs["decoder"], "num_layers": 2})
        depth["num_bins"], points = 16, 64
    return kwargs, depth, sample(kwargs, points)


@pytest.mark.slow
def test_train_losses_golden(monkeypatch, one_sample):
    losses_golden(monkeypatch, *one_sample)


@pytest.mark.slow
def test_train_step_gradients_golden(monkeypatch, one_sample):
    step_golden(monkeypatch, *one_sample)
