"""The PyTorch port's streaming eval slice against the JAX package.

The JAX `RaCFormer` with the fused fold gather (the eval path; its Pallas
kernel runs in interpret mode here) and the port run the same weights on the
same inputs at a tiny config: 2 cameras, 2 frames, embed_dims 256 (the fold
gather needs 64 channels per group), 12 queries, 64x128 images, a 32^2 BEV
grid, 2 decoder layers, float32 everywhere. The JAX init zeroes the sampler
offset and mixing-generator kernels, so those and the BatchNorm statistics
are perturbed with seeded numpy before the weights go to the port through
`state_dict_from_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.eval import decode_boxes as jax_decode_boxes
from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess

from racformer_tpu_torch.eval import StreamingEvaluator
from racformer_tpu_torch.model import RaCFormer, preprocess_images
from racformer_tpu_torch.tools.convert_weights import state_dict_from_jax

TINY = dict(num_cams=2, num_frames=2, embed_dims=256, num_query=12,
            num_clusters=2, image_hw=(64, 128), depth_bins=16,
            bev_size=(32, 32), num_decoder_layers=2)
ARG_KEYS = ("radar_points", "radar_mask", "radar_depth", "radar_rcs",
            "lidar2img", "img2lidar", "time_diff")


def ring_batch(seed, B=1, T=2, N=2, H=64, W=128, P=64):
    """Cameras on a ring around the ego car, looking outwards, with a focal
    length that gives each a 90 degree horizontal view, so that the
    decoder's image sample points land in view."""
    rng = np.random.default_rng(seed)
    l2i = np.broadcast_to(np.eye(4, dtype=np.float32), (B, T, N, 4, 4)).copy()
    for n in range(N):
        yaw = 2 * np.pi * n / N
        R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1],
                      [np.cos(yaw), np.sin(yaw), 0]], np.float32)
        K = np.array([[W / 2, 0, W / 2], [0, W / 2, H / 2], [0, 0, 1]],
                     np.float32)
        l2i[:, :, n, :3, :3] = K @ R
    return dict(
        imgs=rng.uniform(0, 255, size=(B, T, N, H, W, 3)).astype(np.float32),
        radar_points=(rng.normal(size=(B, T, P, 7)) * 10).astype(np.float32),
        radar_mask=np.ones((B, T, P), bool),
        radar_depth=rng.uniform(0, 60, size=(B, T, N, H, W)).astype(np.float32),
        radar_rcs=rng.uniform(-30, 30, size=(B, T, N, H, W)).astype(np.float32),
        lidar2img=l2i,
        img2lidar=np.linalg.inv(l2i).astype(np.float32),
        time_diff=np.tile(np.arange(T, dtype=np.float32) * 0.5, (B, 1)),
    )


def perturb(variables, seed):
    """numpy copy of the flax variables with every all-zero parameter given
    small seeded values and random BatchNorm statistics."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.array(node)
        if path[0] == "batch_stats":
            if path[-1] == "mean":
                return (rng.normal(size=a.shape) * 0.2).astype(a.dtype)
            return (0.5 + rng.uniform(size=a.shape)).astype(a.dtype)
        if not a.any():
            return (rng.normal(size=a.shape) * 0.02).astype(a.dtype)
        return a

    return walk(jax.tree_util.tree_map(np.asarray, variables), ())


@pytest.fixture(scope="module")
def pair():
    batch = ring_batch(0)
    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32,
                          decoder={"gather_dtype": jnp.float32},
                          fused_gather=True, train_mode=False)
    jargs = [jax_preprocess(jnp.asarray(batch["imgs"]))] + [
        jnp.asarray(batch[k]) for k in ARG_KEYS]
    variables = perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jargs), 1)
    model = RaCFormer(**TINY, trunk_dtype=torch.float32,
                      decoder={"gather_dtype": torch.float32})
    model.load_state_dict(state_dict_from_jax(variables, model))
    model.eval()
    # one jitted forward; the encode stage's outputs (every frame of the
    # window) are captured from the LSS and radar branches
    keep = lambda mdl, method: method == "__call__" and mdl.name in (
        "img_lss_view_transformer", "radar_encoder")
    want, state = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, capture_intermediates=keep, mutable=["intermediates"]))(
            variables, *jargs)
    return batch, state["intermediates"], model, want


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_encode_frame_matches_jax(pair):
    batch, inter, model, _ = pair
    (lss, depth), = inter["img_lss_view_transformer"]["__call__"]
    radar, = inter["radar_encoder"]["__call__"]
    B, T = batch["imgs"].shape[:2]
    flat = lambda a: a.reshape(B * T, *a.shape[2:])
    t = _t(batch)
    _, lss_t, radar_t, depth_t = model.encode_frame(
        flat(preprocess_images(t["imgs"])), flat(t["radar_points"]),
        flat(t["radar_mask"]), flat(t["radar_depth"]), flat(t["radar_rcs"]),
        flat(t["img2lidar"]))
    np.testing.assert_allclose(lss_t.numpy(), np.asarray(lss), rtol=1e-3,
                               atol=1e-3, err_msg="LSS BEV")
    np.testing.assert_allclose(radar_t.numpy(), np.asarray(radar), rtol=1e-3,
                               atol=1e-3, err_msg="radar BEV")
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth).reshape(
        depth_t.shape), rtol=1e-3, atol=1e-3, err_msg="depth logits")


def test_offline_forward_matches_jax(pair):
    batch, _, model, want = pair
    t = _t(batch)
    sampled = []
    sampler = model.pts_bbox_head.transformer.decoder.decoder_layer.sampling
    hook = sampler.register_forward_hook(lambda m, i, o: sampled.append(o))
    try:
        got = model(preprocess_images(t["imgs"]), *[t[k] for k in ARG_KEYS])
    finally:
        hook.remove()
    # the ring cameras put image sample points in view: the image branch
    # gathers real features, not only the zero border
    assert all((s != 0).float().mean() > 0.2 for s in sampled)
    np.testing.assert_allclose(got["depth_logits"].numpy(),
                               np.asarray(want["depth_logits"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["all_cls_scores"].numpy(),
                               np.asarray(want["all_cls_scores"]),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got["all_bbox_preds"].numpy(),
                               np.asarray(want["all_bbox_preds"]),
                               rtol=1e-3, atol=2e-3)


def test_streaming_steps_match_jax_offline(pair):
    """Two streaming steps (oldest frame first) hold the offline window;
    their decoded boxes match the JAX offline forward's."""
    batch, _, model, want = pair
    ev = StreamingEvaluator(model)
    for t in (1, 0):
        frame = {k: batch[k][0, t] for k in (
            "imgs", "radar_points", "radar_mask", "radar_depth", "radar_rcs",
            "lidar2img", "img2lidar")}
        frame["timestamp"] = -0.5 * t
        out = ev.step(frame)
    ref = jax.device_get(jax_decode_boxes(want["all_cls_scores"][-1],
                                          want["all_bbox_preds"][-1]))
    np.testing.assert_allclose(out["scores"], ref["scores"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out["bboxes"], ref["bboxes"], rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_array_equal(out["labels"], ref["labels"])
    ev.reset()
    assert ev.cache is None


def test_dense_pillars_match_jax():
    """Many points in few pillars, so the first-10 cap and the max-pool
    both act; masked and out-of-range points included."""
    from racformer_tpu.ops import pillars as jp
    from racformer_tpu_torch.ops import pillars as tp

    rng = np.random.default_rng(5)
    P = 300
    pts = rng.normal(size=(P, 7)).astype(np.float32)
    pts[:, :2] = rng.choice([-3.3, 0.4, 7.9, 60.0], size=(P, 2)) + rng.uniform(
        0, 0.5, size=(P, 2))
    mask = rng.uniform(size=P) < 0.9
    grid = dict(pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                voxel_size=(3.2, 3.2, 8.0), nx=32, ny=32)
    feats, ids, valid = jp.augment_pillar_points(
        jnp.asarray(pts), jnp.asarray(mask), jp.PillarGrid(**grid), 10)
    feats_t, ids_t, valid_t = tp.augment_pillar_points(
        torch.from_numpy(pts), torch.from_numpy(mask), tp.PillarGrid(**grid), 10)
    assert int(valid_t.sum()) < int(mask.sum())  # the cap dropped points
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids))
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats), rtol=1e-5,
                               atol=1e-5)
    bev = jp.pillar_bev_features(feats, ids, valid, jp.PillarGrid(**grid))
    bev_t = tp.pillar_bev_features(feats_t, ids_t, valid_t, tp.PillarGrid(**grid))
    np.testing.assert_allclose(bev_t.numpy(), np.asarray(bev), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("legacy", ["v1.0.0", "v0.17.1"])
def test_decode_boxes_matches_jax(legacy):
    """NaN logits never reach top-k; range check before the z-shift; the
    legacy flip."""
    from racformer_tpu_torch.eval import decode_boxes

    rng = np.random.default_rng(6)
    cls = rng.normal(size=(2, 40, 10)).astype(np.float32) * 3
    cls[0, :5] = np.nan
    box = rng.normal(size=(2, 40, 10)).astype(np.float32)
    box[..., :2] *= 50
    want = jax.device_get(jax_decode_boxes(
        jnp.asarray(cls), jnp.asarray(box), max_num=50, legacy_version=legacy))
    got = decode_boxes(torch.from_numpy(cls), torch.from_numpy(box), max_num=50,
                       legacy_version=legacy)
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-5)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
