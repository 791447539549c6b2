"""The training pieces of the PyTorch port against the JAX package, each
on the same numpy inputs: Hungarian matching (equal assignments), the
detection, DN and depth losses with the accumulation normalizers, the
optimizer (AdamW step, schedule, frozen labels, clip norm), the
augmentation with equal draws, train-mode BatchNorm against flax, and the
port's copy of the synthetic dataset against the JAX package's.

Tolerances: the losses and the optimizer 1e-5 relative (float32, sums in
another order); augmentation 1e-4 absolute on 0-255 pixels; BatchNorm 1e-5;
matching and the synthetic dataset exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.data import SyntheticDataset as JaxSyntheticDataset
from racformer_tpu.model import augment as jaug
from racformer_tpu.train import losses as jlosses
from racformer_tpu.train import matching as jmatch
from racformer_tpu.train import optim as joptim

from racformer_tpu_torch.data import SyntheticDataset
from racformer_tpu_torch.model import augment
from racformer_tpu_torch.nn.layers import BatchNorm, FrozenBatchNorm
from racformer_tpu_torch.train import losses, matching, optim

RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _gt(rng, B, G, n_valid):
    boxes = np.zeros((B, G, 9), np.float32)
    boxes[..., 0:2] = rng.uniform(-45, 45, (B, G, 2))
    boxes[..., 2] = rng.uniform(-2, 1, (B, G))
    boxes[..., 3:6] = rng.uniform(0.5, 6, (B, G, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    boxes[..., 7:9] = rng.normal(size=(B, G, 2))
    labels = rng.integers(0, 10, (B, G)).astype(np.int32)
    mask = np.arange(G)[None] < np.asarray(n_valid)[:, None]
    boxes[~mask] = 0.0  # padding slots, as the datasets leave them
    labels[~mask] = 0
    return boxes, labels, mask


def _outs(rng, L, B, Q, G, ngroup=3):
    def preds(n):
        box = rng.normal(size=(L, B, n, 10)).astype(np.float32)
        box[..., :2] *= 40.0
        return rng.normal(size=(L, B, n, 10)).astype(np.float32) * 2, box

    cls, box = preds(Q)
    dn_cls, dn_box = preds(ngroup * G)
    return cls, box, dn_cls, dn_box


@pytest.mark.parametrize("Q,G", [(30, 6), (900, 64)])
def test_assignment_equals_jax(Q, G):
    rng = np.random.default_rng(Q)
    L, B = 2, 2
    boxes, labels, mask = _gt(rng, B, G, [G - 2, G // 3])
    cls, box, _, _ = _outs(rng, L, B, Q, G)
    cost_j = jax.vmap(jax.vmap(
        lambda c, b, gb, gl, gm: jmatch.match_cost(c, b, gb, gl, gm,
                                                   jlosses.CODE_WEIGHTS)),
        in_axes=(0, 0, None, None, None))(cls, box, boxes, labels, mask)
    cost = matching.match_cost(t(cls), t(box), t(boxes)[None], t(labels)[None],
                               t(mask)[None], losses.CODE_WEIGHTS)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_j), rtol=RTOL,
                               atol=1e-5)
    want = np.asarray(jmatch.hungarian_assign(cost_j))
    got = matching.hungarian_assign(t(np.asarray(cost_j))).numpy()
    np.testing.assert_array_equal(got, want)
    # every valid GT gets its own query
    for l in range(L):
        for b in range(B):
            q = got[l, b][mask[b]]
            assert len(set(q.tolist())) == len(q)


@pytest.mark.parametrize("pos_norm", [None, 2.5])
def test_detection_and_dn_losses_match_jax(pos_norm):
    rng = np.random.default_rng(3)
    L, B, Q, G, ng = 2, 2, 20, 5, 3
    boxes, labels, mask = _gt(rng, B, G, [5, 2])
    cls, box, dn_cls, dn_box = _outs(rng, L, B, Q, G, ng)
    dn_valid = np.tile(mask, (1, ng))
    jouts = {"all_cls_scores": jnp.asarray(cls), "all_bbox_preds": jnp.asarray(box),
             "dn_cls_scores": jnp.asarray(dn_cls),
             "dn_bbox_preds": jnp.asarray(dn_box),
             "dn_meta": {"dn_valid": jnp.asarray(dn_valid)}}
    want = jlosses.detection_loss(
        jouts, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
        pos_norm=None if pos_norm is None else jnp.float32(pos_norm))
    touts = {"all_cls_scores": t(cls), "all_bbox_preds": t(box),
             "dn_cls_scores": t(dn_cls), "dn_bbox_preds": t(dn_box),
             "dn_valid": t(dn_valid)}
    got = losses.detection_loss(
        touts, t(boxes), t(labels), t(mask),
        pos_norm=None if pos_norm is None else torch.tensor(pos_norm))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)


def test_depth_loss_and_fg_norm_match_jax():
    rng = np.random.default_rng(4)
    B, N, H, W, D = 2, 2, 64, 128, 16
    logits = rng.normal(size=(B, N, H // 16, W // 16, D)).astype(np.float32)
    gt = rng.uniform(0.5, 70, (B, N, H, W)) * (rng.uniform(size=(B, N, H, W)) < 0.1)
    gt = gt.astype(np.float32)
    kw = dict(num_bins=D, downsample=16)
    for fg_norm in (None, 3.0):
        want = jlosses.depth_loss(jnp.asarray(logits), jnp.asarray(gt), **kw,
                                  fg_norm=fg_norm)
        got = losses.depth_loss(t(logits), t(gt), **kw, fg_norm=fg_norm)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(
        float(losses.depth_fg_count(t(gt), **kw)),
        float(jlosses.depth_fg_count(jnp.asarray(gt), **kw)))


def test_accumulation_normalizers_make_the_mean_exact():
    """The mean over interleaved microbatches of the losses normalized by
    the full batch's counts / A equals the full-batch loss."""
    rng = np.random.default_rng(5)
    L, B, Q, G = 2, 4, 12, 4
    boxes, labels, mask = _gt(rng, B, G, [4, 1, 0, 3])
    cls, box, _, _ = _outs(rng, L, B, Q, G)
    full = losses.detection_loss(
        {"all_cls_scores": t(cls), "all_bbox_preds": t(box)}, t(boxes),
        t(labels), t(mask))["loss_total"]
    A = 2
    norm = t(mask).sum().float().clamp(min=1.0) / A
    parts = [losses.detection_loss(
        {"all_cls_scores": t(cls[:, a::A]), "all_bbox_preds": t(box[:, a::A])},
        t(boxes[a::A]), t(labels[a::A]), t(mask[a::A]), pos_norm=norm)
        ["loss_total"] for a in range(A)]
    np.testing.assert_allclose(float(sum(parts) / A), float(full), rtol=RTOL)


JAX_TREE_PATHS = {  # flax path -> port name
    "img_backbone/conv1/kernel": "img_backbone.conv1.weight",
    "img_backbone/bn1/scale": "img_backbone.bn1.weight",
    "img_backbone/layer1_0/conv2/kernel": "img_backbone.layer1.0.conv2.weight",
    "img_backbone/layer2_0/conv2/kernel": "img_backbone.layer2.0.conv2.weight",
    "pts_bbox_head/decoder/layer/sampling/sampling_offset/kernel":
        "pts_bbox_head.transformer.decoder.decoder_layer.sampling."
        "sampling_offset.weight",
    "pts_bbox_head/decoder/layer/fusion/kernel":
        "pts_bbox_head.transformer.decoder.decoder_layer.fusion.weight",
    "pts_bbox_head/decoder/layer/fusion/bias":
        "pts_bbox_head.transformer.decoder.decoder_layer.fusion.bias",
}


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_param_labels():
    """Stem and layer1 frozen, the rest of the backbone and the sampling
    offsets at 0.1x lr. (The JAX `_param_label` also freezes `conv1` / `bn1`
    of every later bottleneck, since it matches those names at any depth;
    the port follows the recipe's `frozen_stages=1`.)"""
    labels = {p: optim.param_label(n) for p, n in JAX_TREE_PATHS.items()}
    assert labels == {
        "img_backbone/conv1/kernel": "frozen",
        "img_backbone/bn1/scale": "frozen",
        "img_backbone/layer1_0/conv2/kernel": "frozen",
        "img_backbone/layer2_0/conv2/kernel": "backbone",
        "pts_bbox_head/decoder/layer/sampling/sampling_offset/kernel": "offset",
        "pts_bbox_head/decoder/layer/fusion/kernel": "normal",
        "pts_bbox_head/decoder/layer/fusion/bias": "normal",
    }
    for path, label in labels.items():
        keys = [jax.tree_util.DictKey(k) for k in path.split("/")]
        assert joptim._param_label(keys) == label, path
    assert optim.param_label("img_backbone.layer2.0.conv1.weight") == "backbone"
    assert joptim._param_label([jax.tree_util.DictKey(k) for k in (
        "img_backbone", "layer2_0", "conv1", "kernel")]) == "frozen"


@pytest.mark.parametrize("step", [0, 1, 499, 500, 501, 9_999])
def test_schedule_matches_optax(step):
    _, sched = joptim.make_optimizer({"a": jnp.zeros(1)}, total_steps=10_000)
    # optax evaluates the cosine in float32
    np.testing.assert_allclose(optim.cosine_warmup_lr(step, total_steps=10_000),
                               float(sched(step)), rtol=RTOL)


def test_adamw_steps_match_optax():
    """Three updates from equal parameters and gradients: the first with
    gradients whose global norm (frozen ones included) is above the clip
    norm, the later ones below it."""
    rng = np.random.default_rng(6)
    shapes = {"img_backbone/conv1/kernel": (3, 4),
              "img_backbone/bn1/scale": (4,),
              "img_backbone/layer1_0/conv2/kernel": (5, 2),
              "img_backbone/layer2_0/conv2/kernel": (2, 3),
              "pts_bbox_head/decoder/layer/sampling/sampling_offset/kernel": (4, 3),
              "pts_bbox_head/decoder/layer/fusion/kernel": (6, 6),
              "pts_bbox_head/decoder/layer/fusion/bias": (6,)}
    params = {p: rng.normal(size=s).astype(np.float32) for p, s in shapes.items()}
    grads = [{p: (rng.normal(size=s) * sc).astype(np.float32)
              for p, s in shapes.items()} for sc in (30.0, 0.5, 0.1)]
    tx, _ = joptim.make_optimizer(_nest(params), total_steps=1000,
                                  warmup_steps=2)
    jp = _nest(params)
    state = tx.init(jp)
    tparams = {JAX_TREE_PATHS[p]: torch.nn.Parameter(t(v).clone())
               for p, v in params.items()}
    opt = optim.Optimizer(tparams.items(), total_steps=1000, warmup_steps=2)
    for g in grads:
        updates, state = tx.update(_nest(g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, updates)
        for p, v in g.items():
            tparams[JAX_TREE_PATHS[p]].grad = t(v).clone()
        norm = opt.step()
        want_norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                                for v in g.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=RTOL)
    for p, v in _flat(jp).items():
        np.testing.assert_allclose(tparams[JAX_TREE_PATHS[p]].detach().numpy(),
                                   np.asarray(v), rtol=RTOL, atol=1e-7,
                                   err_msg=p)
    for n, p in opt.frozen().items():  # frozen: never moved
        path = {v: k for k, v in JAX_TREE_PATHS.items()}[n]
        np.testing.assert_array_equal(p.detach().numpy(), params[path])


def _jax_photo_draws(key, B):
    """The draws `racformer_tpu.model.augment.photometric_distortion` makes
    from `key`, in the port's form."""
    ks = jax.random.split(key, 8)
    u = lambda k, lo, hi: jax.random.uniform(k, (B,), minval=lo, maxval=hi)
    b = lambda k: jax.random.bernoulli(k, 0.5, (B,))
    d = {"do_b": b(ks[0]), "delta": u(ks[1], -32.0, 32.0),
         "do_c": b(ks[2]), "alpha": u(ks[3], 0.5, 1.5),
         "do_s": b(ks[4]), "sat": u(ks[5], 0.5, 1.5),
         "do_h": b(ks[6]), "ang": u(ks[7], -18.0, 18.0)}
    return {k: t(v) for k, v in d.items()}


def _jax_grid_draws(key, H):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    d = int(jax.random.randint(k2, (), 2, H))
    return {"apply": bool(jax.random.bernoulli(k1, 0.7)), "d": d,
            "st_h": int(jax.random.randint(k3, (), 0, d)),
            "st_w": int(jax.random.randint(k4, (), 0, d))}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmentation_matches_jax_with_equal_draws(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (3, 2, 16, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jaug.photometric_distortion(key, jnp.asarray(imgs))
    # the batch shape the JAX step uses puts the per-sample draws on axis 0
    got = augment.photometric_distortion(t(imgs), _jax_photo_draws(key, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    gkey = jax.random.PRNGKey(100 + seed)
    want = jaug.grid_mask(gkey, jnp.asarray(imgs))
    got = augment.grid_mask(t(imgs), _jax_grid_draws(gkey, 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augmentation_draws_have_the_jax_ranges():
    gen = torch.Generator().manual_seed(0)
    d = augment.photometric_draws(4000, gen)
    assert 0.45 < d["do_b"].float().mean() < 0.55
    assert d["alpha"].min() >= 0.5 and d["alpha"].max() < 1.5
    assert d["ang"].abs().max() <= 18.0
    grids = [augment.grid_mask_draws(64, gen) for _ in range(300)]
    assert all(2 <= g["d"] < 64 and 0 <= g["st_h"] < g["d"] for g in grids)
    assert 0.6 < np.mean([g["apply"] for g in grids]) < 0.8


@pytest.mark.parametrize("kind", ["bn", "pfn", "bf16"])
def test_train_batchnorm_matches_flax(kind):
    """Output, gradients and updated running statistics of one train-mode
    BatchNorm call: the biased variance goes into the running variance
    (flax), not torch's unbiased one."""
    import flax.linen as fnn

    rng = np.random.default_rng(7)
    x = rng.normal(2.0, 3.0, size=(3, 5, 7, 16)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    mom, eps, fast = {"pfn": (0.99, 1e-3, False)}.get(kind, (0.9, 1e-5, True))
    dtype = jnp.bfloat16 if kind == "bf16" else jnp.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=mom, epsilon=eps,
                       use_fast_variance=fast, dtype=dtype)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                            "bias": rng.normal(size=16).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=16).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 16).astype(np.float32)}}

    def f(xx, params):
        out, upd = bn.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            xx.astype(dtype), mutable=["batch_stats"])
        return out.astype(jnp.float32), upd["batch_stats"]

    want, vjp, stats = jax.vjp(f, jnp.asarray(x), variables["params"],
                               has_aux=True)
    dx, dparams = vjp(jnp.asarray(g))

    m = BatchNorm(16, eps=eps, momentum=1 - mom, fast_variance=fast).train()
    with torch.no_grad():
        m.weight.copy_(t(variables["params"]["scale"]))
        m.bias.copy_(t(variables["params"]["bias"]))
        m.running_mean.copy_(t(variables["batch_stats"]["mean"]))
        m.running_var.copy_(t(variables["batch_stats"]["var"]))
    xt = t(x).requires_grad_()
    tdt = torch.bfloat16 if kind == "bf16" else torch.float32
    out = m(xt.to(tdt)).float()
    out.backward(t(g))
    tol = 2e-2 if kind == "bf16" else 1e-5
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)
    if kind != "bf16":
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-4,
                                   atol=1e-5)
        # sums over the 105 rows of each channel, in another order
        np.testing.assert_allclose(m.weight.grad.numpy(),
                                   np.asarray(dparams["scale"]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(m.bias.grad.numpy(),
                                   np.asarray(dparams["bias"]), rtol=1e-4,
                                   atol=1e-5)


def test_frozen_batchnorm_never_updates():
    m = FrozenBatchNorm(8).train()
    before = (m.running_mean.clone(), m.running_var.clone())
    out = m(torch.randn(4, 3, 8) * 5)
    out.sum().backward()
    assert torch.equal(m.running_mean, before[0])
    assert torch.equal(m.running_var, before[1])
    assert m.weight.grad is not None


@pytest.mark.parametrize("kw", [
    dict(num_samples=3, num_cams=2, num_frames=2, hw=(16, 32),
         max_radar_points=40, max_gt=5, seed=0),
    dict(num_samples=2, num_cams=6, num_frames=3, hw=(8, 24),
         max_radar_points=64, max_gt=30, seed=7)])
def test_synthetic_dataset_equals_the_jax_packages(kw):
    ours, ref = SyntheticDataset(**kw), JaxSyntheticDataset(**kw)
    assert len(ours) == len(ref)
    got, want = ours.batch(range(len(ours))), ref.batch(range(len(ref)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
