"""KITTI-protocol 3D detection metrics (for the VoD variant).

The reference's VoD dataset evaluates with mmdet3d's `kitti_eval`
(the reference's `loaders/vod_mono_dataset.py:311-378`). This is a
self-contained reimplementation of that protocol: per-class AP with rotated
BEV / 3D IoU matching, 40-point interpolated precision, plus the VoD paper's
two evaluation regions (entire annotated area, and the driving corridor
|x| < 4 m, 0 < z < 25 m in camera coords).

A copy of `racformer_tpu/eval/kitti_eval.py` (the port imports nothing of
the JAX package); `tests/test_torch_eval_parts.py` holds the copy equal to
its original.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

VOD_CLASSES = ("Car", "Pedestrian", "Cyclist")
IOU_THRESH = {"Car": 0.5, "Pedestrian": 0.25, "Cyclist": 0.25}


def _box_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """boxes: [N, 5] (cx, cz, w, l, yaw) -> corners [N, 4, 2]."""
    cx, cz, w, l, yaw = boxes.T
    # counter-clockwise corner order (the polygon clipper requires CCW)
    dx = np.stack([l / 2, -l / 2, -l / 2, l / 2], 1)
    dz = np.stack([w / 2, w / 2, -w / 2, -w / 2], 1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    x = cx[:, None] + dx * c - dz * s
    z = cz[:, None] + dx * s + dz * c
    return np.stack([x, z], axis=-1)


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _cross2(a, b) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex polygon clipping."""
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        inp, out = out, []
        if not inp:
            break
        prev = inp[-1]
        prev_in = _cross2(edge, prev - a) >= 0
        for cur in inp:
            cur_in = _cross2(edge, cur - a) >= 0
            if cur_in != prev_in:
                den = _cross2(cur - prev, edge)
                if abs(den) > 1e-12:
                    t = _cross2(a - prev, edge) / den
                    out.append(prev + t * (cur - prev))
            if cur_in:
                out.append(cur)
            prev, prev_in = cur, cur_in
    return np.asarray(out) if out else np.zeros((0, 2))


def rotated_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """[Na, 5] x [Nb, 5] (cx, cz, w, l, yaw) -> IoU matrix [Na, Nb]."""
    ca = _box_corners_bev(boxes_a)
    cb = _box_corners_bev(boxes_b)
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    out = np.zeros((len(boxes_a), len(boxes_b)))
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            inter_poly = _clip_polygon(ca[i], cb[j])
            if len(inter_poly) < 3:
                continue
            inter = _polygon_area(inter_poly)
            out[i, j] = inter / max(area_a[i] + area_b[j] - inter, 1e-9)
    return out


def iou_3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """[Na, 7] x [Nb, 7] (x, y, z, w, l, h, yaw) camera coords (y down):
    rotated BEV overlap x vertical overlap."""
    bev_a = boxes_a[:, [0, 2, 3, 4, 6]]
    bev_b = boxes_b[:, [0, 2, 3, 4, 6]]
    ca = _box_corners_bev(bev_a)
    cb = _box_corners_bev(bev_b)
    out = np.zeros((len(boxes_a), len(boxes_b)))
    for i in range(len(boxes_a)):
        # camera coords: box bottom at y, extends up (−y) by h
        a_top, a_bot = boxes_a[i, 1] - boxes_a[i, 5], boxes_a[i, 1]
        va = boxes_a[i, 3] * boxes_a[i, 4] * boxes_a[i, 5]
        for j in range(len(boxes_b)):
            inter_poly = _clip_polygon(ca[i], cb[j])
            if len(inter_poly) < 3:
                continue
            inter_bev = _polygon_area(inter_poly)
            b_top, b_bot = boxes_b[j, 1] - boxes_b[j, 5], boxes_b[j, 1]
            h_inter = max(0.0, min(a_bot, b_bot) - max(a_top, b_top))
            inter = inter_bev * h_inter
            vb = boxes_b[j, 3] * boxes_b[j, 4] * boxes_b[j, 5]
            out[i, j] = inter / max(va + vb - inter, 1e-9)
    return out


def _class_ap(preds, gts, iou_fn, thresh) -> float:
    """40-point interpolated AP. preds: list (sample, score, box); gts:
    dict sample -> [G, 7]."""
    npos = sum(len(v) for v in gts.values())
    if npos == 0:
        return float("nan")
    preds = sorted(preds, key=lambda x: -x[1])
    taken = {k: np.zeros(len(v), bool) for k, v in gts.items()}
    tp, fp, scores = [], [], []
    for s_idx, score, box in preds:
        gt = gts.get(s_idx)
        matched = False
        if gt is not None and len(gt):
            ious = iou_fn(box[None], gt)[0]
            ious[taken[s_idx]] = -1
            j = int(np.argmax(ious))
            if ious[j] >= thresh:
                taken[s_idx][j] = True
                matched = True
        tp.append(1.0 if matched else 0.0)
        fp.append(0.0 if matched else 1.0)
        scores.append(score)
    tp, fp = np.cumsum(tp), np.cumsum(fp)
    rec = tp / npos
    prec = tp / np.maximum(tp + fp, 1e-9)
    # monotone precision envelope + 40-point sampling (R40 protocol)
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    sample_points = np.linspace(1.0 / 40, 1.0, 40)
    p = np.zeros(40)
    for i, r in enumerate(sample_points):
        idx = np.searchsorted(rec, r)
        p[i] = prec[idx] if idx < len(prec) else 0.0
    return float(p.mean())


def _in_corridor(box_cam: np.ndarray) -> bool:
    """VoD driving corridor: camera coords |x| < 4 m, 0 < z < 25 m."""
    return abs(box_cam[0]) < 4.0 and 0.0 < box_cam[2] < 25.0


def kitti_vod_metrics(
    preds: List[Dict],
    gts: List[Dict],
    class_names: Sequence[str] = VOD_CLASSES,
) -> Dict[str, float]:
    """preds[i]: dict(bboxes [K, 7] camera-frame (x, y, z, w, l, h, ry),
    scores [K], labels [K]); gts[i]: dict(bboxes [G, 7], labels [G]).

    Returns per-class AP_3D for the entire area and the driving corridor,
    plus their means (the VoD paper's headline metrics).
    """
    out = {}
    for region in ("all", "corridor"):
        aps = []
        for c, name in enumerate(class_names):
            pc, gc = [], {}
            for i, (p, g) in enumerate(zip(preds, gts)):
                sel = np.asarray(p["labels"]) == c
                for b, s in zip(np.asarray(p["bboxes"])[sel], np.asarray(p["scores"])[sel]):
                    if region == "all" or _in_corridor(b):
                        pc.append((i, float(s), b))
                gsel = np.asarray(g["labels"]) == c
                gb = np.asarray(g["bboxes"])[gsel]
                if region == "corridor" and len(gb):
                    gb = gb[[_in_corridor(b) for b in gb]]
                if len(gb):
                    gc[i] = gb
            ap = _class_ap(pc, gc, iou_3d, IOU_THRESH[name])
            out[f"AP3D_{region}_{name}"] = ap
            if not np.isnan(ap):
                aps.append(ap)
        out[f"mAP3D_{region}"] = float(np.mean(aps)) if aps else 0.0
    return out
