"""The port against the JAX package at full width: the flagship config
(6 cameras, 8 frames, 256x704, Q = 900, C = 256, 6 decoder iterations, D =
96, BEV 128^2) and the VoD config (1 camera, 1 frame, Q = 600), each with
the port's seeded random weights converted into the JAX model, on one
seeded ring-camera sample with the config's radar points, float32
everywhere. In `tests/test_integration_golden.py`'s order: the encode stage
(LSS BEV, radar BEV), then the depth logits, then the final class scores
and boxes.

The VoD case runs in tier 1 (one camera, one frame: ~20 s on the CPU);
the flagship case is marked `slow` (a full-size JAX compile and 48 images
in one test worker). `hold_golden` returns each stage's largest deviation
beside its tolerance and names them in its assertion messages; run with
`-s` to print them. `golden_pair` / `hold_golden` also serve
`tests/test_torch_vod.py` at tiny shapes, where the JAX side runs its
fused fold kernel (K1's Pallas original) in interpret mode; at full width
it takes its plain CPU path, as the JAX package's goldens do.

Tolerances: at tiny shapes `tests/test_torch_slice.py`'s (1e-3; 2e-3 for
the head's outputs), at full width `tests/test_integration_golden.py`'s at
flagship shapes (depth logits 2e-3 / 3e-3, scores and boxes 2e-3 / 5e-3;
the encode stage 2e-3 / 3e-3): sums over 6 x 8 images, 96 depth bins and 6
decoder iterations, taken in another order.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.tools.convert_weights import convert_state_dict

from racformer_tpu_torch.config import Config
from racformer_tpu_torch.model import (RaCFormer, config_kwargs,
                                       preprocess_images, random_init_)
from tests.test_torch_slice import ring_batch

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "racformer_tpu_torch" / "configs"
ARG_KEYS = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
            "lidar2img", "img2lidar", "time_diff")
TINY_TOL = dict(encode=(1e-3, 1e-3), depth=(1e-3, 1e-3), head=(1e-3, 2e-3))
FULL_TOL = dict(encode=(2e-3, 3e-3), depth=(2e-3, 3e-3), head=(2e-3, 5e-3))


def golden_pair(kwargs, batch, seed, fused=True, tol=TINY_TOL):
    """The port model of `kwargs` with seeded random weights (eval mode,
    float32), the JAX model with the same weights (`fused`: its fold
    kernel in interpret mode, else its CPU default), and the JAX forward on
    `batch` with the encode stage's outputs captured."""
    dec = dict(kwargs["decoder"])
    model = RaCFormer(**{**kwargs, "decoder": {**dec,
                                               "gather_dtype": torch.float32}},
                      trunk_dtype=torch.float32)
    random_init_(model, torch.Generator().manual_seed(seed)).eval()
    jmodel = JaxRaCFormer(
        **{k: v for k, v in kwargs.items() if k != "decoder"},
        decoder={**dec, "gather_dtype": jnp.float32},
        trunk_dtype=jnp.float32, fused_gather=True if fused else None,
        train_mode=False)
    jargs = [jax_preprocess(jnp.asarray(batch["imgs"]))] + [
        jnp.asarray(batch[k]) for k in ARG_KEYS]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *jargs))
    variables, unmatched = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, template,
        strict=True)
    assert unmatched == []
    keep = lambda mdl, method: method == "__call__" and mdl.name in (
        "img_lss_view_transformer", "radar_encoder")
    want, state = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, capture_intermediates=keep, mutable=["intermediates"]))(
            variables, *jargs)
    return dict(batch=batch, model=model, jmodel=jmodel, variables=variables,
                want=jax.tree_util.tree_map(np.asarray, want),
                inter=state["intermediates"], tol=tol)


def in_view_share(num_cams):
    """The least share of the image sampler's outputs that must be nonzero:
    one ring camera of 90 degrees sees about a quarter of the queries'
    directions (0.17-0.19 at the tiny VoD config), six see them all."""
    return 0.2 if num_cams > 1 else 0.1


def hold_golden(pair):
    """The encode stage, the depth logits, then the final scores and boxes
    of the port's forward against the JAX forward's; the image sampler
    reads real features (not only its zero border). Returns {stage:
    (largest |port - JAX|, largest |JAX|, (rtol, atol))}, the deviation
    also in each assertion's message."""
    batch, model, want, inter = (pair[k] for k in ("batch", "model", "want",
                                                  "inter"))
    tol = pair["tol"]
    (lss, depth), = inter["img_lss_view_transformer"]["__call__"]
    radar, = inter["radar_encoder"]["__call__"]
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    B, T = batch["imgs"].shape[:2]
    flat = lambda a: a.reshape(B * T, *a.shape[2:])
    sampled = []
    sampler = model.pts_bbox_head.transformer.decoder.decoder_layer.sampling
    hook = sampler.register_forward_hook(lambda m, i, o: sampled.append(o))
    try:
        with torch.no_grad():
            _, lss_t, radar_t, depth_t = model.encode_frame(
                flat(preprocess_images(t["imgs"])), flat(t["radar_points"]),
                flat(t["radar_mask"]), flat(t["radar_depth"]),
                flat(t["radar_rcs"]), flat(t["img2lidar"]))
            got = model(preprocess_images(t["imgs"]), *[t[k] for k in ARG_KEYS])
    finally:
        hook.remove()
    stages = (("LSS BEV", "encode", lss_t, lss),
              ("radar BEV", "encode", radar_t, radar),
              ("depth logits (encode)", "depth", depth_t,
               np.asarray(depth).reshape(depth_t.shape)),
              ("depth logits", "depth", got["depth_logits"],
               want["depth_logits"]),
              ("final cls scores", "head", got["all_cls_scores"],
               want["all_cls_scores"]),
              ("final bbox preds", "head", got["all_bbox_preds"],
               want["all_bbox_preds"]))
    report = {}
    for name, kind, port, ref in stages:
        port, ref = port.numpy(), np.asarray(ref)
        rtol, atol = tol[kind]
        report[name] = (float(np.abs(port - ref).max()),
                        float(np.abs(ref).max()), (rtol, atol))
        np.testing.assert_allclose(
            port, ref, rtol=rtol, atol=atol,
            err_msg=f"{name}: largest deviation {report[name][0]:.3g} "
                    f"(largest |value| {report[name][1]:.3g}) against rtol "
                    f"{rtol}, atol {atol}")
    least = in_view_share(model.num_cams)
    assert all((s != 0).float().mean() > least for s in sampled)
    return report


@pytest.mark.parametrize("config", [
    pytest.param("racformer_r50_nuimg_704x256_f8.py", marks=pytest.mark.slow),
    pytest.param("racformer_r50_nuimg_704x256_f8_3cam_3rad.py",
                 marks=pytest.mark.slow),
    "racformer_vod.py"])
def test_full_width_golden(config):
    cfg = Config.fromfile(str(CONFIGS / config))
    kwargs = config_kwargs(cfg)
    H, W = kwargs["image_hw"]
    batch = ring_batch(0, T=kwargs["num_frames"], N=kwargs["num_cams"], H=H,
                       W=W, P=int(cfg["radar"]["max_points"]))
    report = hold_golden(golden_pair(kwargs, batch, seed=0, fused=False,
                                     tol=FULL_TOL))
    for name, (dev, top, (rtol, atol)) in report.items():
        print(f"{config} {name}: largest deviation {dev:.4g} (largest |value| "
              f"{top:.4g}); rtol {rtol}, atol {atol}")
