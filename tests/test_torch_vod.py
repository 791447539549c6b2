"""The VoD configuration (`racformer_tpu_torch/configs/racformer_vod.py`: 1
camera, 1 frame, 3 classes, KITTI protocol) of the port against the JAX
package on the CPU.

The model is the config's, at `tests/test_drivers.py`'s tiny VoD overrides
(600 -> 12 queries, 64x128 images, 16 depth bins, a 32^2 BEV grid, 2
clusters) but for `embed_dims`: 256, not 64, so that each of the 4 groups
has 64 channels. With 64 a group has 16, the fused map 2C = 32 lanes, and
the JAX package then takes neither its custom VJP (K2-K4, `bilinear.py:473`
wants 2C == 128) nor its fold kernel (K1): the comparison would silently
hold the port's kernels' plain versions against plain autodiff. float32
everywhere; the JAX side runs its Pallas kernels in interpret mode.

* The offline forward, in `tests/test_integration_golden.py`'s order: the
  encode stage (LSS BEV, radar BEV), the depth logits, the final scores and
  boxes (`tests/test_torch_golden.py` holds the helper; tolerances there).
* `StreamingEvaluator.step` over 3 frames: a one-slot ring whose window is
  the newest frame alone, time_diff 0, the decoder's `num_frames > 1`
  branch skipped; each step against the JAX evaluator's step and against
  the port's own offline forward on that frame.
* One train step: `tests/test_torch_vod_train.py` (a file of its own, so
  that the test runner's workers compile the two JAX programs in
  parallel).
* The VoD reader, collate and the KITTI metrics on the VoD smoke's fixture
  (`racformer_tpu_torch/tools/vod_smoke.py`) against the JAX package's.
"""

import pathlib

import numpy as np
import pytest
import torch

from racformer_tpu.data.collate import collate as jax_collate
from racformer_tpu.data.vod import VoDDataset as JaxVoD
from racformer_tpu.eval import streaming as jstreaming
from racformer_tpu.eval.offline import detection_metrics as jax_detection_metrics

from racformer_tpu_torch.config import Config
from racformer_tpu_torch.data.collate import collate
from racformer_tpu_torch.data.vod import VoDDataset
from racformer_tpu_torch.eval import StreamingEvaluator, decode_boxes
from racformer_tpu_torch.eval.offline import detection_metrics
from racformer_tpu_torch.model import config_kwargs, preprocess_images
from racformer_tpu_torch.tools.vod_smoke import build_fixture

from tests.test_torch_golden import golden_pair, hold_golden
from tests.test_torch_slice import ring_batch
from tests.test_torch_tools import assert_same

REPO = pathlib.Path(__file__).resolve().parents[1]
VOD_CONFIG = REPO / "racformer_tpu_torch" / "configs" / "racformer_vod.py"
# tests/test_drivers.py's VoD overrides, embed_dims 256 (see above)
TINY_VOD = ["model.embed_dims=256", "model.num_query=12",
            "model.num_clusters=2", "model.image_hw=(64,128)",
            "model.depth_bins=16", "model.bev_size=(32,32)", "model.max_gt=8",
            "radar.max_points=64", "batch_size_per_chip=1", "depth.num_bins=16"]
FRAME_KEYS = ("imgs", "radar_points", "radar_mask", "radar_depth",
              "radar_rcs", "lidar2img", "img2lidar")


def vod_kwargs(*extra):
    """The VoD config's model arguments at the tiny overrides."""
    cfg = Config.fromfile(str(VOD_CONFIG)).merge_override(TINY_VOD + list(extra))
    kw = config_kwargs(cfg)
    assert (kw["num_cams"], kw["num_frames"], kw["num_classes"]) == (1, 1, 3)
    return kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny runs: the test runner's
    workers share the cores, and spinning thread pools there cost ~50x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return golden_pair(vod_kwargs(), ring_batch(0, T=1, N=1), seed=2)


def test_encode_forward_matches_jax(pair):
    """Encode stage, depth logits, final scores and boxes; the image branch
    samples real features (the camera looks along +x with a 90 degree
    view)."""
    hold_golden(pair)


def _frames(n):
    """n frames of one camera, each its own seeded ring batch, 0.5 s apart."""
    out = []
    for t in range(n):
        b = ring_batch(10 + t, T=1, N=1)
        f = {k: b[k][0, 0] for k in FRAME_KEYS}
        f["imgs"] = f["imgs"].astype(np.uint8)
        f["timestamp"] = 0.5 * t
        out.append(f)
    return out


def test_streaming_three_frames_match_jax(pair):
    """num_frames = 1: the ring holds one slot, so each step's window is
    its own frame (time_diff 0) and its boxes are the offline forward's on
    that frame alone; each step matches the JAX evaluator's within
    `tests/test_torch_slice.py`'s bounds."""
    model, jmodel, variables = pair["model"], pair["jmodel"], pair["variables"]
    ev = StreamingEvaluator(model)
    jev = jstreaming.StreamingEvaluator(jmodel, variables)
    for t, f in enumerate(_frames(3)):
        got = ev.step(f)
        want = jev.step(f)
        feat_cat, lss, radar, l2i, ts = ev.cache
        assert lss.shape[1] == radar.shape[1] == l2i.shape[1] == ts.shape[1] == 1
        assert float(ts[0, 0]) == f["timestamp"]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=2e-3,
                                   atol=2e-3, err_msg=f"t={t}")
        np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=2e-2,
                                   atol=2e-2, err_msg=f"t={t}")
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["valid"], want["valid"])
        # the window is the frame alone: the offline forward on it
        tf = {k: torch.from_numpy(np.asarray(f[k]))[None, None]
              for k in FRAME_KEYS}
        with torch.no_grad():
            outs = model(preprocess_images(tf["imgs"].float()),
                         *[tf[k] for k in FRAME_KEYS[1:]],
                         torch.zeros(1, 1))
        alone = decode_boxes(outs["all_cls_scores"][-1],
                             outs["all_bbox_preds"][-1], **ev.decode_cfg)
        for k in ("scores", "bboxes"):
            np.testing.assert_allclose(got[k], alone[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"t={t} {k}")


@pytest.mark.parametrize("hw", [(64, 128), (128, 352)])
def test_reader_collate_and_kitti_metrics_match_jax(tmp_path, hw):
    """The VoD smoke's fixture (48 samples, PNG images, radar on the boxes)
    through both readers (at the fixture's size and resized up), both
    collates and both KITTI evaluations."""
    pkl = build_fixture(str(tmp_path))
    kw = dict(image_hw=hw, max_radar_points=64, max_gt=8)
    port, jax_ds = VoDDataset(pkl, **kw), JaxVoD(pkl, **kw)
    assert len(port) == len(jax_ds) == 48
    for i in (0, 5, 47):
        assert_same(port[i], jax_ds[i], f"sample {i}")
    assert port[0]["imgs"].max() > 200  # the bright boxes decoded
    idx = [3, 4, 9]
    assert_same(collate([port[i] for i in idx]),
                jax_collate([jax_ds[i] for i in idx]), "collate")
    rng = np.random.default_rng(2)
    preds, gts = [], []
    for i in range(8):
        s = port[i]
        m = s["gt_mask"]
        boxes = np.zeros((12, 9), np.float32)
        n = int(m.sum())
        boxes[:n] = s["gt_bboxes"][m]
        boxes[:n, :3] += rng.normal(scale=0.3, size=(n, 3))
        boxes[n:, :3] = rng.uniform(-10, 30, (12 - n, 3))
        boxes[n:, 3:6] = rng.uniform(0.5, 4, (12 - n, 3))
        preds.append(dict(bboxes=boxes, scores=rng.uniform(0.1, 1, 12),
                          labels=np.concatenate([s["gt_labels"][m],
                                                 rng.integers(0, 3, 12 - n)]),
                          valid=np.ones(12, bool)))
        gts.append(dict(bboxes=s["gt_bboxes"], labels=s["gt_labels"],
                        mask=m))
    got = detection_metrics(preds, gts, is_vod=True)
    want = jax_detection_metrics(preds, gts, is_vod=True)
    assert_same(got, want, "kitti")
    assert got["mAP3D_all"] > 0.1


def test_vod_best_checkpoint_metric():
    """The VoD config inherits `evaluation.save_best="NDS"` from its
    nuScenes base, and `train.py` reads it (so it never saves `best/` on
    VoD: the KITTI metrics have no NDS); the port's driver picks mAP3D_all
    there, and keeps every other choice."""
    from racformer_tpu_torch.train.__main__ import best_metric

    cfg = Config.fromfile(str(VOD_CONFIG))
    assert cfg["evaluation"]["save_best"] == "NDS"
    line = 'ev_cfg.get(\n        "save_best", "mAP3D_all" if cfg.get("dataset_type") == "vod"'
    assert line in (REPO / "train.py").read_text()
    assert best_metric(cfg) == "mAP3D_all"
    assert best_metric(cfg.merge_override(
        ["evaluation.save_best='mAP3D_corridor'"])) == "mAP3D_corridor"
    flagship = Config.fromfile(str(REPO / "racformer_tpu_torch" / "configs"
                                   / "racformer_r50_nuimg_704x256_f8.py"))
    assert best_metric(flagship) == "NDS"
    assert best_metric(flagship.merge_override(
        ["evaluation.save_best='mAP'"])) == "mAP"
