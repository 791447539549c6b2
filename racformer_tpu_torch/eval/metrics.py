"""Self-contained nuScenes-protocol detection metrics.

The reference delegates to the nuScenes devkit (the reference's `val.py:19-51`),
which is not available in this environment; this module implements the same
protocol from its public definition: per-class AP by BEV center-distance
matching at {0.5, 1, 2, 4} m with 101-point interpolated precision normalized
over recall/precision > 10%, TP metrics (ATE/ASE/AOE/AVE/AAE) accumulated over
the recall range at the 2 m threshold, and
NDS = (5*mAP + sum_tp (1 - min(1, err))) / 10.

Also implements the fork's front-only evaluation mode (filter GT and
predictions to ego x > 0, `loaders/nuscenes_dataset.py:40-181`) behind an
explicit flag.

Class names index the standard 10 nuScenes detection classes; attribute
errors (AAE) are only computed when `attrs` are provided (synthetic data has
none), otherwise mAAE reports 1.0 (max error) so NDS stays conservative.

A copy of `racformer_tpu/eval/metrics.py` (the port imports nothing of the
JAX package); `tests/test_torch_eval_parts.py` holds the copy equal to its
original.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

CLASS_NAMES = (
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier",
)
DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
# classes where velocity error is not evaluated (protocol)
NO_VELOCITY = {"traffic_cone", "barrier"}
# classes with no attribute annotation (excluded from mAAE, protocol)
NO_ATTRIBUTE = {"traffic_cone", "barrier"}
# the devkit also excludes traffic cones from ORIENTATION error (they have
# no meaningful yaw): evaluate.py's per-class TP selection sets
# orient_err = NaN for traffic_cone alongside vel/attr
NO_ORIENT = {"traffic_cone"}
# classes where orientation is evaluated mod pi (protocol: barrier)
PERIOD_PI = {"barrier"}
# per-class max evaluation range in meters (nuScenes detection_cvpr_2019
# `class_range`); boxes beyond it are dropped from preds and GT
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}


def _size_iou(pred_wlh: np.ndarray, gt_wlh: np.ndarray) -> float:
    """Aligned 3D IoU of sizes (translation/rotation-free, protocol ASE)."""
    inter = np.prod(np.minimum(pred_wlh, gt_wlh))
    union = np.prod(pred_wlh) + np.prod(gt_wlh) - inter
    return float(inter / max(union, 1e-9))


def _yaw_diff(a: float, b: float, period: float) -> float:
    d = (a - b) % period
    return float(min(d, period - d))


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit `cummean`: NaN-aware cumulative mean; an all-NaN input returns
    ones (max error), positions before the first valid value are 0."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(np.float64))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals),
                     where=count_vals > 0)


def _no_predictions_md():
    """devkit `DetectionMetricData.no_predictions`."""
    return dict(
        precision=np.zeros(101), confidence=np.zeros(101),
        trans_err=np.ones(101), scale_err=np.ones(101),
        orient_err=np.ones(101), vel_err=np.ones(101), attr_err=np.ones(101),
    )


def _accumulate(preds_c, gts_c, dist_th: float, yaw_period: float = 2 * np.pi,
                gt_attrs_c=None):
    """One (class, threshold) accumulation — exact devkit `accumulate`
    semantics (nuscenes-devkit detection/algo.py):

      * greedy match by BEV center distance in score order (strict <, each
        GT taken once);
      * precision/confidence interpolated onto the 101-point recall grid;
      * TP-error curves built from TP events ONLY (NaN-aware cumulative
        mean over the matched sequence), then mapped onto the recall grid
        THROUGH the interpolated confidence curve — not directly by recall
        (round 2 interpolated the all-prediction cummean by recall, which
        deviates whenever FPs interleave with TPs).

    preds_c: list of (sample_idx, score, box9, attr_or_None);
    gts_c: dict sample -> [G, 9]; gt_attrs_c: dict sample -> [G] int attrs.
    """
    npos = sum(len(v) for v in gts_c.values())
    if npos == 0:
        return None
    if len(preds_c) == 0:
        return _no_predictions_md()
    preds_sorted = sorted(preds_c, key=lambda x: -x[1])
    taken = {k: np.zeros(len(v), bool) for k, v in gts_c.items()}
    tp, fp, confs = [], [], []
    match = {"trans_err": [], "scale_err": [], "orient_err": [],
             "vel_err": [], "attr_err": [], "conf": []}
    for s_idx, score, box, attr in preds_sorted:
        gt = gts_c.get(s_idx)
        best, best_j = 1e18, -1
        if gt is not None and len(gt):
            d = np.hypot(gt[:, 0] - box[0], gt[:, 1] - box[1])
            d[taken[s_idx]] = 1e18
            best_j = int(np.argmin(d))
            best = float(d[best_j])
        if best < dist_th:
            taken[s_idx][best_j] = True
            tp.append(1.0)
            fp.append(0.0)
            g = gt[best_j]
            match["trans_err"].append(best)
            match["scale_err"].append(1.0 - _size_iou(box[3:6], g[3:6]))
            match["orient_err"].append(_yaw_diff(box[6], g[6], yaw_period))
            match["vel_err"].append(
                float(np.hypot(box[7] - g[7], box[8] - g[8])))
            if attr is not None and gt_attrs_c and s_idx in gt_attrs_c:
                ga = int(gt_attrs_c[s_idx][best_j])
                # devkit `attr_acc`: GT without a valid attribute (no
                # annotation record, or an empty attribute like barriers)
                # is EXCLUDED from AAE (NaN = not counted), not max error
                match["attr_err"].append(
                    float(int(attr) != ga) if ga > 0 else np.nan)
            else:
                match["attr_err"].append(1.0)  # no attrs at all: conservative
            match["conf"].append(score)
        else:
            tp.append(0.0)
            fp.append(1.0)
        confs.append(score)

    if not match["conf"]:  # no matches at all (devkit: no_predictions)
        return _no_predictions_md()

    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    prec = tp / (tp + fp)
    rec = tp / float(npos)

    rec_interp = np.linspace(0, 1, 101)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, confs, right=0)

    md = dict(precision=prec_i, confidence=conf_i)
    mconf = np.asarray(match["conf"], np.float64)
    for key in ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err"):
        tmp = _cummean(np.asarray(match[key], np.float64))
        # map the TP-sequence cummean onto the recall grid via confidence
        # (devkit: np.interp needs increasing x, hence the double reversal)
        md[key] = np.interp(conf_i[::-1], mconf[::-1], tmp[::-1])[::-1]
    return md


def _ap_from_md(md) -> float:
    prec = md["precision"].copy()
    prec = prec[int(MIN_RECALL * 100) + 1 :]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec) / (1.0 - MIN_PRECISION))


def _tp_from_md(md, key: str) -> float:
    first = int(MIN_RECALL * 100) + 1
    # devkit `max_recall_ind`: the last recall index with nonzero confidence
    nz = np.nonzero(md["confidence"])[0]
    last = int(nz[-1]) if len(nz) else 0
    if last < first:
        return 1.0
    return float(np.mean(md[key][first : last + 1]))


def nuscenes_metrics(
    preds: List[Dict],
    gts: List[Dict],
    class_names: Sequence[str] = CLASS_NAMES,
    front_only: bool = False,
    class_range: Optional[Dict[str, float]] = None,
    return_curves: bool = False,
    gt_filter: Optional[Callable] = None,
) -> Dict[str, float]:
    """preds[i]: dict(bboxes [K, 9], scores [K], labels [K], valid [K],
    optional attrs [K] int); gts[i]: dict(bboxes [G, 9], labels [G], mask [G],
    optional attrs [G] int, optional num_pts [G] int, optional ego_xy [2]
    — the ego-vehicle origin in the box frame).

    Protocol filters implemented as in the devkit's `filter_eval_boxes`:
    per-class max range measured from the EGO pose when `ego_xy` is present
    (the devkit measures ego-frame distance; the lidar origin sits ~1 m away
    — `gen_sweep_info` bakes `ego2lidar_xy` into infos) and removal of GT
    boxes with zero lidar+radar points when `num_pts` is present.

    Bike-rack step (devkit `filter_eval_boxes`, implemented — round-5): the
    devkit drops bicycle/motorcycle boxes (BOTH GT and predictions) whose
    center lies inside any `static_object.bicycle_rack` annotation box of
    the sample. GT carries per-box `in_bikerack` flags baked by
    `gen_sweep_info.collect_gt` (-1 = unknown -> keep); predictions are
    tested against the sample's `bikeracks` [K, 7] lidar-frame rack boxes
    (padding rows have w <= 0).

    `gt_filter(sample_idx, boxes [G, 9], labels [G], gt_dict) -> keep [G]`
    remains a pluggable last-stage GT filter applied after all protocol
    filters (custom protocol studies).
    """
    num_classes = len(class_names)
    ranges = dict(CLASS_RANGE) if class_range is None else dict(class_range)
    per_class_preds = {c: [] for c in range(num_classes)}
    per_class_gts = {c: {} for c in range(num_classes)}
    per_class_gt_attrs = {c: {} for c in range(num_classes)}

    def in_range(boxes, labels, ego_xy):
        r = np.asarray([ranges.get(class_names[int(l)], 1e9) for l in labels])
        return np.hypot(boxes[:, 0] - ego_xy[0], boxes[:, 1] - ego_xy[1]) <= r

    bike_cls = {c for c, n in enumerate(class_names)
                if n in ("bicycle", "motorcycle")}

    def in_any_rack(boxes, racks):
        """Center-in-rack-box test (devkit `points_in_box`); boxes are
        bottom-center-z 9-dim predictions, racks gravity-center [K, 7]
        (x, y, z, w, l, h, yaw); rack padding rows have w <= 0."""
        racks = racks[racks[:, 3] > 0]
        if not len(racks) or not len(boxes):
            return np.zeros(len(boxes), bool)
        p = boxes[:, :3].copy()
        p[:, 2] += boxes[:, 5] / 2.0  # bottom -> gravity center
        hit = np.zeros(len(boxes), bool)
        for r in racks:
            d = p - r[:3]
            cs, sn = np.cos(-r[6]), np.sin(-r[6])
            lx = cs * d[:, 0] - sn * d[:, 1]
            ly = sn * d[:, 0] + cs * d[:, 1]
            hit |= ((np.abs(lx) <= r[4] / 2) & (np.abs(ly) <= r[3] / 2)
                    & (np.abs(d[:, 2]) <= r[5] / 2))
        return hit

    for i, (p, g) in enumerate(zip(preds, gts)):
        ego_xy = np.asarray(g.get("ego_xy", (0.0, 0.0)), np.float64)
        valid = np.asarray(p["valid"], bool)
        boxes = np.asarray(p["bboxes"])[valid]
        scores = np.asarray(p["scores"])[valid]
        labels = np.asarray(p["labels"])[valid]
        attrs = np.asarray(p["attrs"])[valid] if "attrs" in p else None
        keep = in_range(boxes, labels, ego_xy)
        if front_only:
            keep &= boxes[:, 0] > 0
        if bike_cls and "bikeracks" in g and len(boxes):
            racks = np.asarray(g["bikeracks"], np.float64).reshape(-1, 7)
            is_bike = np.isin(labels, list(bike_cls))
            if is_bike.any():
                keep &= ~(is_bike & in_any_rack(boxes, racks))
        boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        attrs = attrs[keep] if attrs is not None else None
        for j, (b, s, l) in enumerate(zip(boxes, scores, labels)):
            a = int(attrs[j]) if attrs is not None else None
            per_class_preds[int(l)].append((i, float(s), b, a))

        gmask = np.asarray(g["mask"], bool)
        gboxes = np.asarray(g["bboxes"])[gmask]
        glabels = np.asarray(g["labels"])[gmask]
        gattrs = np.asarray(g["attrs"])[gmask] if "attrs" in g else None
        keep = in_range(gboxes, glabels, ego_xy)
        if "num_pts" in g:  # devkit: drop GT with KNOWN-zero lidar+radar
            # points (negative = unknown -> keep)
            keep &= np.asarray(g["num_pts"])[gmask] != 0
        if bike_cls and "in_bikerack" in g:
            # devkit bike-rack step: drop bicycle/motorcycle GT whose center
            # sits in a bike-rack annotation box (flag baked by
            # gen_sweep_info; -1 = unknown -> keep)
            flag = np.asarray(g["in_bikerack"])[gmask]
            keep &= ~(np.isin(glabels, list(bike_cls)) & (flag == 1))
        if front_only:
            keep &= gboxes[:, 0] > 0
        gboxes, glabels = gboxes[keep], glabels[keep]
        gattrs = gattrs[keep] if gattrs is not None else None
        if gt_filter is not None and len(gboxes):
            keep = np.asarray(gt_filter(i, gboxes, glabels, g), bool)
            gboxes, glabels = gboxes[keep], glabels[keep]
            gattrs = gattrs[keep] if gattrs is not None else None
        for c in range(num_classes):
            sel = glabels == c
            if sel.any():
                per_class_gts[c][i] = gboxes[sel]
                if gattrs is not None:
                    per_class_gt_attrs[c][i] = gattrs[sel]

    aps = []
    tp_errs = {"trans_err": [], "scale_err": [], "orient_err": [],
               "vel_err": [], "attr_err": []}
    curves: Dict = {}
    per_class: Dict[str, Dict[str, float]] = {}
    for c in range(num_classes):
        cls_aps = []
        name = class_names[c]
        period = np.pi if name in PERIOD_PI else 2 * np.pi
        pc = {}
        for th in DIST_THRESHOLDS:
            md = _accumulate(per_class_preds[c], per_class_gts[c], th, period,
                             gt_attrs_c=per_class_gt_attrs[c])
            ap = _ap_from_md(md) if md is not None else np.nan
            cls_aps.append(ap)
            if md is not None:
                curves[(name, th)] = md
                pc[f"AP@{th}"] = ap
            if th == TP_THRESHOLD and md is not None:
                for key, excl in (("trans_err", ()), ("scale_err", ()),
                                  ("orient_err", NO_ORIENT),
                                  ("vel_err", NO_VELOCITY),
                                  ("attr_err", NO_ATTRIBUTE)):
                    v = _tp_from_md(md, key)
                    if name not in excl:
                        tp_errs[key].append(v)
                        pc[key] = v
        if not np.all(np.isnan(cls_aps)):
            aps.append(np.nanmean(cls_aps))
            pc["AP"] = float(np.nanmean(cls_aps))
        if pc:
            per_class[name] = pc

    mAP = float(np.mean(aps)) if aps else 0.0
    out = {"mAP": mAP}
    out["mATE"] = float(np.mean(tp_errs["trans_err"])) if tp_errs["trans_err"] else 1.0
    out["mASE"] = float(np.mean(tp_errs["scale_err"])) if tp_errs["scale_err"] else 1.0
    out["mAOE"] = float(np.mean(tp_errs["orient_err"])) if tp_errs["orient_err"] else 1.0
    out["mAVE"] = float(np.mean(tp_errs["vel_err"])) if tp_errs["vel_err"] else 1.0
    out["mAAE"] = float(np.mean(tp_errs["attr_err"])) if tp_errs["attr_err"] else 1.0
    tp_sum = sum(max(0.0, 1.0 - min(1.0, out[k])) for k in
                 ("mATE", "mASE", "mAOE", "mAVE", "mAAE"))
    out["NDS"] = float((5.0 * mAP + tp_sum) / 10.0)
    if return_curves:
        # non-scalar diagnostics for tools/eval_plots.py (the devkit's
        # DetectionMetricDataList equivalent): {(class, th): md curves} and
        # per-class AP / TP-error scalars
        out["curves"] = curves
        out["per_class"] = per_class
    return out
