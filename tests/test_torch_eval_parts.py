"""The port's numpy copies of the evaluation code against their originals,
bit for bit: the nuScenes metrics (every filter and the curves), the VoD
KITTI metrics and rotated IoUs, the metric dispatch, the predicted-attribute
labelling, the ground-truth extraction and the submission export. The port's
metrics are also held to the independent devkit transliteration of
`tests/devkit_oracle.py`, bike-rack filter included."""

import numpy as np
import pytest

from racformer_tpu.eval import kitti_eval as jkitti
from racformer_tpu.eval import metrics as jmetrics
from racformer_tpu.eval import offline as joffline
from racformer_tpu.tools import export_results as jexport
from racformer_tpu.tools.gen_sweep_info import ATTRIBUTES as JATTRIBUTES
from racformer_tpu.tools.gen_sweep_info import point_in_any_box

from racformer_tpu_torch.eval import kitti_eval, metrics, offline
from racformer_tpu_torch.tools import export_results
from racformer_tpu_torch.tools.gen_sweep_info import ATTRIBUTES
from tests.devkit_oracle import evaluate as oracle_evaluate
from tests.devkit_oracle import filter_bikeracks


def assert_same(got, want, path="result"):
    """Nested dicts / lists / arrays / floats equal bit for bit (NaN equal
    to NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def scenes(seed, n_samples=6):
    """Random predictions and ground truth over all ten classes with every
    optional field: attributes (some missing), point counts (some zero), the
    ego origin, bike-rack flags and rack boxes, invalid predictions."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_samples):
        G, K = int(rng.integers(2, 12)), int(rng.integers(1, 16))
        gtb = np.zeros((G, 9), np.float32)
        gtb[:, 0:2] = rng.uniform(-55, 55, size=(G, 2))
        gtb[:, 2] = rng.uniform(-2, 1, size=G)
        gtb[:, 3:6] = rng.uniform(0.4, 5.0, size=(G, 3))
        gtb[:, 6] = rng.uniform(-np.pi, np.pi, size=G)
        gtb[:, 7:9] = rng.normal(size=(G, 2))
        glab = rng.integers(0, 10, size=G)
        pick = rng.integers(0, G, size=K)
        pb = gtb[pick] + rng.normal(scale=0.6, size=(K, 9)).astype(np.float32)
        pb[:, 3:6] = np.abs(pb[:, 3:6]) + 0.2
        plab = np.where(rng.random(K) < 0.2, rng.integers(0, 10, size=K),
                        glab[pick])
        racks = np.zeros((8, 7), np.float32)
        racks[0] = [gtb[0, 0], gtb[0, 1], 0.0, 4.0, 6.0, 4.0, 0.3]
        preds.append(dict(bboxes=pb, scores=rng.uniform(0.05, 1.0, size=K),
                          labels=plab, valid=rng.random(K) < 0.9,
                          attrs=rng.integers(0, 9, size=K)))
        gts.append(dict(bboxes=gtb, labels=glab, mask=rng.random(G) < 0.9,
                        attrs=np.where(rng.random(G) < 0.3, -1,
                                       rng.integers(1, 9, size=G)),
                        num_pts=rng.integers(0, 5, size=G),
                        ego_xy=rng.normal(size=2).astype(np.float32),
                        in_bikerack=rng.integers(-1, 2, size=G),
                        bikeracks=racks))
    return preds, gts


@pytest.mark.parametrize("seed, options", [
    (0, {}),
    (1, {"front_only": True}),
    (2, {"return_curves": True}),
    (3, {"class_range": {"car": 30.0, "pedestrian": 20.0}}),
    (4, {"gt_filter": lambda i, b, l, g: (l != 5) & (i % 2 == 0 or b[:, 0] > 0)}),
])
def test_nuscenes_metrics_equal_original(seed, options):
    preds, gts = scenes(seed)
    assert_same(metrics.nuscenes_metrics(preds, gts, **options),
                jmetrics.nuscenes_metrics(preds, gts, **options))


def test_nuscenes_metrics_match_devkit_oracle():
    """The randomized multi-class case of tests/test_metrics.py, the port's
    copy against the devkit transliteration."""
    rng = np.random.default_rng(42)
    names = ("car", "pedestrian", "barrier", "traffic_cone")
    label = {n: metrics.CLASS_NAMES.index(n) for n in names}
    preds, gts = [], []
    o_gt = {n: [] for n in names}
    o_pred = {n: [] for n in names}
    for s in range(5):
        G = int(rng.integers(3, 8))
        gtb = np.zeros((G, 9), np.float32)
        gtb[:, 0:2] = rng.uniform(-20, 20, size=(G, 2))
        gtb[:, 3:6] = rng.uniform(0.5, 4.0, size=(G, 3))
        gtb[:, 6] = rng.uniform(-np.pi, np.pi, size=G)
        gtb[:, 7:9] = rng.normal(size=(G, 2))
        gname = rng.choice(names, size=G)
        glab = np.array([label[n] for n in gname])
        gattr = np.where(rng.random(G) < 0.3, -1,
                         rng.integers(1, 8, size=G)).astype(np.int64)
        K = int(rng.integers(2, 10))
        pick = rng.integers(0, G, size=K)
        pb = gtb[pick].copy()
        pb[:, 0:2] += rng.normal(scale=1.2, size=(K, 2))
        pb[:, 3:6] = np.maximum(pb[:, 3:6] + rng.normal(scale=0.4, size=(K, 3)),
                                0.2)
        pb[:, 6] += rng.normal(scale=0.5, size=K)
        pb[:, 7:9] += rng.normal(scale=0.5, size=(K, 2))
        plab = glab[pick].copy()
        flip = rng.random(K) < 0.2
        plab[flip] = np.array([label[n] for n in
                               rng.choice(names, size=int(flip.sum()))])
        pscore = rng.uniform(0.05, 1.0, size=K)
        pattr = rng.integers(1, 8, size=K).astype(np.int64)
        preds.append(dict(bboxes=pb, scores=pscore, labels=plab,
                          valid=np.ones(K, bool), attrs=pattr))
        gts.append(dict(bboxes=gtb, labels=glab, mask=np.ones(G, bool),
                        attrs=gattr))
        for j in range(G):
            o_gt[gname[j]].append(dict(
                sample=s, x=gtb[j, 0], y=gtb[j, 1], w=gtb[j, 3], l=gtb[j, 4],
                h=gtb[j, 5], yaw=gtb[j, 6], vx=gtb[j, 7], vy=gtb[j, 8],
                attr=int(gattr[j])))
        for j in range(K):
            name = names[[label[n] for n in names].index(plab[j])]
            o_pred[name].append(dict(
                sample=s, x=pb[j, 0], y=pb[j, 1], w=pb[j, 3], l=pb[j, 4],
                h=pb[j, 5], yaw=pb[j, 6], vx=pb[j, 7], vy=pb[j, 8],
                attr=int(pattr[j]), score=float(pscore[j])))
    got = metrics.nuscenes_metrics(preds, gts)
    want = oracle_evaluate(o_gt, o_pred, names)
    for k in ("mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE", "NDS"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, err_msg=k)


def test_bikerack_filter_matches_devkit_oracle():
    """Bicycle and motorcycle boxes inside a rack dropped on both sides (GT
    by its baked flag, predictions by the rack boxes), as the devkit does."""
    rng = np.random.default_rng(7)
    names = ("bicycle", "motorcycle", "car")
    label = {n: metrics.CLASS_NAMES.index(n) for n in names}
    preds, gts, racks_by_sample = [], [], {}
    o_gt = {n: [] for n in names}
    o_pred = {n: [] for n in names}
    for s in range(4):
        rack = dict(x=5.0, y=5.0, z=1.0, w=4.0, l=6.0, h=2.0,
                    yaw=float(rng.uniform(-np.pi, np.pi)))
        racks_by_sample[s] = [rack]
        G = int(rng.integers(4, 8))
        gtb = np.zeros((G, 9), np.float32)
        gtb[:, 0:2] = rng.uniform(-20, 20, size=(G, 2))
        gtb[: G // 2, 0:2] = [5.0, 5.0]
        gtb[:, 3:6] = rng.uniform(0.5, 2.0, size=(G, 3))
        gtb[:, 6] = rng.uniform(-np.pi, np.pi, size=G)
        gname = rng.choice(names, size=G)
        glab = np.array([label[n] for n in gname])
        K = int(rng.integers(3, 8))
        pick = rng.integers(0, G, size=K)
        pb = gtb[pick].copy()
        pb[:, 0:2] += rng.normal(scale=0.8, size=(K, 2))
        plab = glab[pick].copy()
        pscore = rng.uniform(0.1, 1.0, size=K)
        rec = [dict(center=[rack["x"], rack["y"], rack["z"]],
                    wlh=[rack["w"], rack["l"], rack["h"]], yaw=rack["yaw"])]
        flags = np.array([int(point_in_any_box(gtb[j, :3].astype(np.float64),
                                               rec)) for j in range(G)],
                         np.int32)
        rpad = np.zeros((8, 7), np.float32)
        rpad[0] = [rack[k] for k in ("x", "y", "z", "w", "l", "h", "yaw")]
        preds.append(dict(bboxes=pb, scores=pscore, labels=plab,
                          valid=np.ones(K, bool)))
        gts.append(dict(bboxes=gtb, labels=glab, mask=np.ones(G, bool),
                        in_bikerack=flags, bikeracks=rpad))
        for j in range(G):
            o_gt[gname[j]].append(dict(
                sample=s, x=gtb[j, 0], y=gtb[j, 1], w=gtb[j, 3], l=gtb[j, 4],
                h=gtb[j, 5], yaw=gtb[j, 6], vx=0.0, vy=0.0, attr=-1,
                z=float(gtb[j, 2])))
        for j in range(K):
            name = names[[label[n] for n in names].index(plab[j])]
            o_pred[name].append(dict(
                sample=s, x=pb[j, 0], y=pb[j, 1], w=pb[j, 3], l=pb[j, 4],
                h=pb[j, 5], yaw=pb[j, 6], vx=0.0, vy=0.0, attr=-1,
                score=float(pscore[j]), z=float(pb[j, 2])))
    got = metrics.nuscenes_metrics(preds, gts)
    assert_same(got, jmetrics.nuscenes_metrics(preds, gts))
    want = oracle_evaluate(
        filter_bikeracks(o_gt, racks_by_sample, z_of=lambda b: b["z"]),
        filter_bikeracks(o_pred, racks_by_sample,
                         z_of=lambda b: b["z"] + b["h"] / 2), names)
    for k in ("mAP", "NDS"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, err_msg=k)
    bare = [dict(bboxes=g["bboxes"], labels=g["labels"], mask=g["mask"])
            for g in gts]
    assert abs(metrics.nuscenes_metrics(preds, bare)["mAP"] - got["mAP"]) > 1e-6


def kitti_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-6, 6, n)
    b[:, 1] = rng.uniform(0.5, 2.0, n)
    b[:, 2] = rng.uniform(2, 40, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_metrics_and_ious_equal_original(seed):
    rng = np.random.default_rng(seed)
    a, b = kitti_boxes(rng, 9), kitti_boxes(rng, 7)
    b[:3] = a[:3] + rng.normal(scale=0.3, size=(3, 7)).astype(np.float32)
    bev_a, bev_b = a[:, [0, 2, 3, 4, 6]], b[:, [0, 2, 3, 4, 6]]
    assert_same(kitti_eval.rotated_iou_bev(bev_a, bev_b),
                jkitti.rotated_iou_bev(bev_a, bev_b))
    assert_same(kitti_eval.iou_3d(a, b), jkitti.iou_3d(a, b))
    preds, gts = [], []
    for _ in range(5):
        g = kitti_boxes(rng, int(rng.integers(1, 8)))
        lab = rng.integers(0, 3, len(g))
        p = g + rng.normal(scale=0.4, size=g.shape).astype(np.float32)
        p = np.concatenate([p, kitti_boxes(rng, 2)])
        preds.append(dict(bboxes=p, scores=rng.uniform(0.1, 1, len(p)),
                          labels=np.concatenate([lab, rng.integers(0, 3, 2)])))
        gts.append(dict(bboxes=g, labels=lab))
    assert_same(kitti_eval.kitti_vod_metrics(preds, gts),
                jkitti.kitti_vod_metrics(preds, gts))


@pytest.mark.parametrize("is_vod", [False, True])
def test_detection_metrics_and_attributes_equal_original(is_vod):
    """The dispatch with predicted-attribute labelling (nuScenes) or the
    VoD KITTI protocol, on decoder-shaped predictions."""
    preds, gts = scenes(5)
    for p in preds:
        del p["attrs"]
    names = list(metrics.CLASS_NAMES)
    got = [dict(p) for p in preds]
    want = [dict(p) for p in preds]
    assert_same(offline.detection_metrics(got, gts, is_vod=is_vod,
                                          class_names=names),
                joffline.detection_metrics(want, gts, is_vod=is_vod,
                                           class_names=names))
    assert_same(got, want)
    if not is_vod:
        assert all("attrs" in p for p in got)


def test_gt_extraction_attributes_and_export_equal_original():
    preds, gts = scenes(6, n_samples=2)
    sample = dict(gt_bboxes=gts[0]["bboxes"], gt_labels=gts[0]["labels"],
                  gt_mask=gts[0]["mask"], gt_attrs=gts[0]["attrs"],
                  gt_num_pts=gts[0]["num_pts"], ego_xy=gts[0]["ego_xy"],
                  gt_in_bikerack=gts[0]["in_bikerack"],
                  gt_bikeracks=gts[0]["bikeracks"])
    assert_same(offline.gather_gt_sample(sample),
                joffline.gather_gt_sample(sample))
    batch = {k: v[None] for k, v in sample.items()}
    assert_same(offline.gather_gt(batch, 0), joffline.gather_gt(batch, 0))
    assert offline.gather_gt_sample({"imgs": 0}) is None
    assert ATTRIBUTES == JATTRIBUTES
    for name in metrics.CLASS_NAMES:
        for v in ((0.0, 0.0), (0.1, 0.1), (1.0, -0.5)):
            assert (export_results.attribute_for(name, *v)
                    == jexport.attribute_for(name, *v))
    tokens = ["a", "b"]
    assert (export_results.to_nuscenes_results(tokens, preds)
            == jexport.to_nuscenes_results(tokens, preds))
