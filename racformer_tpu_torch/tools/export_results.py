"""Export predictions to the nuScenes submission JSON format.

Capability match for the reference's result formatting (mmdet3d
`format_results` -> nuScenes `results_nusc.json` used by `val.py`'s devkit
evaluation and the test-server submission path). Self-contained: converts
decoded lidar-frame boxes to per-sample result records with class names,
translation/size/rotation(quaternion)/velocity/score.

Usage (library):
  records = to_nuscenes_results(tokens, preds, class_names)
  json.dump({"meta": DEFAULT_META, "results": records}, f)

A copy of `racformer_tpu/tools/export_results.py` (the port imports nothing
of the JAX package); `tests/test_torch_eval_parts.py` holds the copy equal
to its original.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

DEFAULT_META = {
    "use_camera": True,
    "use_lidar": False,
    "use_radar": True,
    "use_map": False,
    "use_external": True,
}

CLASS_NAMES = (
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier",
)

# mmdet3d NuScenesDataset.DefaultAttribute — the convention behind the
# reference's submissions (its val.py formats boxes via mmdet3d
# `_format_bbox`, which picks attributes velocity-aware; see
# `attribute_for`)
DEFAULT_ATTRS = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "trailer": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider", "motorcycle": "cycle.without_rider",
    "pedestrian": "pedestrian.moving", "traffic_cone": "", "barrier": "",
}

_VEHICLES = ("car", "construction_vehicle", "bus", "truck", "trailer")


def attribute_for(name: str, vx: float, vy: float) -> str:
    """mmdet3d's velocity-aware attribute rule (`nuscenes_dataset.py
    _format_bbox`): moving vehicles/cycles override the per-class default;
    slow pedestrians stand, slow buses stop."""
    if (vx * vx + vy * vy) ** 0.5 > 0.2:
        if name in _VEHICLES:
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRS.get(name, "")
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRS.get(name, "")


def yaw_to_quaternion(yaw: float) -> List[float]:
    """[w, x, y, z] for a rotation about +z."""
    return [float(np.cos(yaw / 2.0)), 0.0, 0.0, float(np.sin(yaw / 2.0))]


def to_nuscenes_results(
    tokens: Sequence[str],
    preds: Sequence[Dict],
    class_names: Sequence[str] = CLASS_NAMES,
) -> Dict[str, List[Dict]]:
    """preds[i]: dict(bboxes [K, 9] (x, y, z_bottom, w, l, h, yaw, vx, vy),
    scores [K], labels [K], valid [K]) in the lidar/ego frame."""
    results: Dict[str, List[Dict]] = {}
    for token, p in zip(tokens, preds):
        keep = np.asarray(p["valid"], bool)
        boxes = np.asarray(p["bboxes"])[keep]
        scores = np.asarray(p["scores"])[keep]
        labels = np.asarray(p["labels"])[keep]
        recs = []
        for b, s, l in zip(boxes, scores, labels):
            name = class_names[int(l)]
            recs.append({
                "sample_token": token,
                # gravity-center translation (decode gives bottom-center z)
                "translation": [float(b[0]), float(b[1]), float(b[2] + b[5] / 2)],
                "size": [float(b[3]), float(b[4]), float(b[5])],
                "rotation": yaw_to_quaternion(float(b[6])),
                "velocity": [float(b[7]), float(b[8])],
                "detection_name": name,
                "detection_score": float(s),
                "attribute_name": attribute_for(
                    name, float(b[7]), float(b[8])),
            })
        results[token] = recs
    return results


def write_submission(path: str, tokens, preds, meta=None):
    with open(path, "w") as f:
        json.dump(
            {"meta": meta or DEFAULT_META,
             "results": to_nuscenes_results(tokens, preds)}, f)
    return path
