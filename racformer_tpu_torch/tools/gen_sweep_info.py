"""Offline nuScenes info generation: camera sweep chains + precomputed radar.

Capability match for `tools/gen_sweep_info.py`
(the reference's `tools/gen_sweep_info.py:18-132`) and the on-the-fly radar
aggregation it leaves to the dataloader (`loaders/nuscenes_dataset.py:346-493`,
`RadarPointCloud_v2.from_file_multisweep`): per keyframe, walk the sample_data
chains to collect inter-keyframe camera sweeps, and aggregate `nsweeps` radar
sweeps per channel into the reference lidar frame — with per-point time lag
and the compensated-velocity rotation into the lidar frame — storing the
resulting [P, 7] arrays directly in the info pkl.

Runs devkit-free off the raw nuScenes table JSONs (sample.json,
sample_data.json, calibrated_sensor.json, ego_pose.json, sensor.json) and a
minimal PCD parser for the radar files, so workers never touch the devkit at
load time (the reference constructs a NuScenes instance at import time in
every worker — `loaders/nuscenes_dataset.py:20-21` — an API wart SURVEY.md
flags for removal).

Usage:
  python -m racformer_tpu_torch.tools.gen_sweep_info \
      --dataroot data/nuscenes --version v1.0-trainval \
      --infos data/nuscenes/nuscenes_infos_train.pkl \
      --out data/nuscenes/nuscenes_infos_train_sweep.pkl

A copy of `racformer_tpu/tools/gen_sweep_info.py` (the port imports nothing
of the JAX package): the nuScenes reader (`data/nuscenes.py`) reads the
infos it writes, and the attribute labelling of predictions codes
attributes with its `ATTRIBUTES`. `tests/test_torch_tools.py` holds it
equal to its original.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List

import numpy as np

RADAR_CHANNELS = (
    "RADAR_FRONT", "RADAR_FRONT_LEFT", "RADAR_FRONT_RIGHT",
    "RADAR_BACK_LEFT", "RADAR_BACK_RIGHT",
)
CAMERA_CHANNELS = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)
# selected radar dims: x, y, z, rcs(5), vx_comp(8), vy_comp(9), time_lag
# (`loaders/pipelines/loading.py:801`)
RADAR_USE_DIMS = (0, 1, 2, 5, 8, 9)


def quat_to_rot(q) -> np.ndarray:
    """[w, x, y, z] -> 3x3 rotation matrix (replaces pyquaternion)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def transform_matrix(translation, rotation_q, inverse=False) -> np.ndarray:
    R = quat_to_rot(rotation_q)
    t = np.asarray(translation, np.float64)
    M = np.eye(4)
    if inverse:
        M[:3, :3] = R.T
        M[:3, 3] = -R.T @ t
    else:
        M[:3, :3] = R
        M[:3, 3] = t
    return M


def read_pcd(path: str) -> np.ndarray:
    """Minimal binary PCD reader for nuScenes radar files -> [P, F] float32."""
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            k, *vals = line.split()
            header[k.upper()] = vals
            if k.upper() == "DATA":
                data_fmt = vals[0]
                break
        fields = header["FIELDS"]
        sizes = list(map(int, header["SIZE"]))
        types = header["TYPE"]
        counts = list(map(int, header.get("COUNT", ["1"] * len(fields))))
        width = int(header["WIDTH"][0])
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
                    ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}
        dtype = np.dtype([
            (name, np_types[(t, s)], c)
            for name, t, s, c in zip(fields, types, sizes, counts)
        ])
        if data_fmt != "binary":
            raise ValueError(f"unsupported PCD data format {data_fmt}")
        raw = np.frombuffer(f.read(dtype.itemsize * width), dtype=dtype)
    return np.stack([raw[name].astype(np.float32).reshape(-1) for name in fields], 1)


class Tables:
    """Raw nuScenes table access (devkit-free)."""

    def __init__(self, dataroot: str, version: str):
        self.dataroot = dataroot
        base = os.path.join(dataroot, version)
        self.sample = self._index(base, "sample")
        self.sample_data = self._index(base, "sample_data")
        self.calibrated_sensor = self._index(base, "calibrated_sensor")
        self.ego_pose = self._index(base, "ego_pose")
        self.sensor = self._index(base, "sensor")
        # annotation tables (optional: absent in stripped-down fixtures)
        self.sample_annotation = self._index_optional(base, "sample_annotation")
        self.attribute = self._index_optional(base, "attribute")
        self.category = self._index_optional(base, "category")
        self.instance = self._index_optional(base, "instance")
        # sample token -> its annotation tokens (raw file order; velocity
        # differencing walks each annotation's prev/next pointers instead)
        self.anns_of_sample: Dict[str, list] = {}
        for a in self.sample_annotation.values():
            self.anns_of_sample.setdefault(a["sample_token"], []).append(
                a["token"])
        # sample token -> {channel: sample_data token} for keyframes
        self.sample_to_sd: Dict[str, Dict[str, str]] = {}
        for sd in self.sample_data.values():
            if not sd["is_key_frame"]:
                continue
            ch = self.channel(sd)
            self.sample_to_sd.setdefault(sd["sample_token"], {})[ch] = sd["token"]

    @staticmethod
    def _index(base: str, name: str) -> Dict[str, Dict]:
        with open(os.path.join(base, f"{name}.json")) as f:
            rows = json.load(f)
        return {r["token"]: r for r in rows}

    @classmethod
    def _index_optional(cls, base: str, name: str) -> Dict[str, Dict]:
        try:
            return cls._index(base, name)
        except FileNotFoundError:
            return {}

    def channel(self, sd: Dict) -> str:
        cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
        return self.sensor[cs["sensor_token"]]["channel"]

    def global_from_sensor(self, sd: Dict) -> np.ndarray:
        cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
        ep = self.ego_pose[sd["ego_pose_token"]]
        return transform_matrix(ep["translation"], ep["rotation"]) @ \
            transform_matrix(cs["translation"], cs["rotation"])

    def sensor_from_global(self, sd: Dict) -> np.ndarray:
        cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
        ep = self.ego_pose[sd["ego_pose_token"]]
        return transform_matrix(cs["translation"], cs["rotation"], inverse=True) @ \
            transform_matrix(ep["translation"], ep["rotation"], inverse=True)


def aggregate_radar(tables: Tables, sample_token: str, nsweeps: int = 5,
                    channels=RADAR_CHANNELS) -> np.ndarray:
    """Aggregate nsweeps per radar channel into the sample's lidar frame.

    Mirrors `RadarPointCloud_v2.from_file_multisweep`
    (`loaders/nuscenes_dataset.py:400-493`): transform points sweep -> global
    -> reference lidar frame, rotate compensated velocities with the combined
    rotation, append per-point time lag. Returns [P, 7].
    """
    sample = tables.sample[sample_token]
    lidar_sd = tables.sample_data[tables.sample_to_sd[sample_token]["LIDAR_TOP"]]
    ref_from_global = tables.sensor_from_global(lidar_sd)
    ref_time = lidar_sd["timestamp"] / 1e6

    out = []
    for ch in channels:
        tok = tables.sample_to_sd[sample_token].get(ch)
        if tok is None:
            continue
        sd = tables.sample_data[tok]
        for _ in range(nsweeps):
            path = os.path.join(tables.dataroot, sd["filename"])
            if os.path.exists(path):
                pts = read_pcd(path)
                M = ref_from_global @ tables.global_from_sensor(sd)
                xyz = pts[:, 0:3] @ M[:3, :3].T + M[:3, 3]
                rcs = pts[:, 5:6]
                vel = pts[:, 8:10] @ M[:2, :2].T  # rotate comp. velocities
                lag = np.full_like(rcs, ref_time - sd["timestamp"] / 1e6)
                out.append(
                    np.concatenate([xyz, rcs, vel, lag], 1).astype(np.float32)
                )
            if not sd["prev"]:
                break
            sd = tables.sample_data[sd["prev"]]
    if not out:
        return np.zeros((0, 7), np.float32)
    return np.concatenate(out, 0)


def collect_camera_sweeps(tables: Tables, sample_token: str,
                          max_sweeps: int = 60) -> List[Dict]:
    """Walk the camera sample_data chains backwards, grouping the 6 cameras
    per sweep step (the reference stores up to 60 sweep dicts,
    `loaders/nuscenes_dataset.py:184-205`).

    Each sweep camera carries a ready `lidar2img` that maps points in the
    *current keyframe's* lidar frame into that sweep's camera — i.e. the
    ego-motion compensation the reference applies via `compose_lidar2img`
    (`loaders/pipelines/loading.py:15-38`):
      lidar2img = viewpad @ cam_from_global(sweep) @ global_from_lidar(key).
    """
    lidar_sd = tables.sample_data[tables.sample_to_sd[sample_token]["LIDAR_TOP"]]
    global_from_ref = tables.global_from_sensor(lidar_sd)

    heads = {}
    for ch in CAMERA_CHANNELS:
        tok = tables.sample_to_sd[sample_token].get(ch)
        if tok:
            heads[ch] = tables.sample_data[tok]
    sweeps = []
    for _ in range(max_sweeps):
        step = {}
        done = False
        for ch, sd in list(heads.items()):
            if not sd["prev"]:
                done = True
                break
            sd = tables.sample_data[sd["prev"]]
            heads[ch] = sd
            cs = tables.calibrated_sensor[sd["calibrated_sensor_token"]]
            K = np.asarray(cs["camera_intrinsic"], np.float64)
            viewpad = np.eye(4)
            viewpad[:3, :3] = K
            cam_from_global = tables.sensor_from_global(sd)
            step[ch] = dict(
                data_path=os.path.join(tables.dataroot, sd["filename"]),
                timestamp=sd["timestamp"],
                cam_intrinsic=K,
                lidar2img=(viewpad @ cam_from_global @ global_from_ref).astype(
                    np.float32
                ),
            )
        if done or len(step) < len(heads):
            break
        sweeps.append(dict(cams=step, timestamp=min(c["timestamp"] for c in step.values())))
    return sweeps


# canonical nuScenes attribute vocabulary (attribute.json names); index 0 is
# "no attribute" (traffic cones / barriers)
ATTRIBUTES = (
    "", "cycle.with_rider", "cycle.without_rider", "pedestrian.moving",
    "pedestrian.standing", "pedestrian.sitting_lying_down", "vehicle.moving",
    "vehicle.parked", "vehicle.stopped",
)


def collect_gt(tables: Tables, sample_token: str) -> List[Dict]:
    """Ground truth straight from the annotation tables, in the LIDAR frame:
    center / (w, l, h) / yaw / velocity (devkit `box_velocity` finite
    difference over prev/next annotations) / attribute name / category /
    point counts. Self-sufficient GT + the attribute and num_pts fields the
    NDS protocol needs (the mmdet3d info pkl carries neither attributes nor,
    in some versions, radar point counts)."""
    if not tables.sample_annotation:
        return []
    lidar_tok = tables.sample_to_sd.get(sample_token, {}).get("LIDAR_TOP")
    if lidar_tok is None:
        return []
    T = tables.sensor_from_global(tables.sample_data[lidar_tok])

    def ann_time(tok):
        a = tables.sample_annotation[tok]
        return tables.sample[a["sample_token"]]["timestamp"] / 1e6

    out = []
    for atok in tables.anns_of_sample.get(sample_token, []):
        a = tables.sample_annotation[atok]
        c = T @ np.array(list(a["translation"]) + [1.0])
        R_l = T[:3, :3] @ quat_to_rot(a["rotation"])
        yaw = float(np.arctan2(R_l[1, 0], R_l[0, 0]))
        w, l, h = a["size"]
        first = a["prev"] or atok
        last = a["next"] or atok
        if first == last:
            v_l = np.zeros(2)
        else:
            p0 = np.asarray(tables.sample_annotation[first]["translation"])
            p1 = np.asarray(tables.sample_annotation[last]["translation"])
            dt = ann_time(last) - ann_time(first)
            v_g = (p1 - p0) / max(dt, 1e-6)
            v_l = (T[:3, :3] @ v_g)[:2]
        attr = ""
        if a.get("attribute_tokens"):
            attr = tables.attribute.get(
                a["attribute_tokens"][0], {}).get("name", "")
        cat = ""
        inst = tables.instance.get(a.get("instance_token", ""), {})
        if inst:
            cat = tables.category.get(
                inst.get("category_token", ""), {}).get("name", "")
        out.append(dict(
            center=[float(c[0]), float(c[1]), float(c[2])],
            wlh=[float(w), float(l), float(h)],
            yaw=yaw,
            velocity=[float(v_l[0]), float(v_l[1])],
            attribute=attr,
            category=cat,
            num_lidar_pts=int(a.get("num_lidar_pts", -1)),
            num_radar_pts=int(a.get("num_radar_pts", -1)),
        ))

    # bike-rack protocol flag: the devkit's `filter_eval_boxes` drops
    # bicycle/motorcycle boxes whose CENTER lies inside any
    # `static_object.bicycle_rack` annotation box of the same sample
    # (nuscenes-devkit eval/detection/loaders.py `points_in_box` over the
    # rack boxes — NOT a map-expansion query, so it needs only the
    # annotation tables this tool already parses). Rigid transforms
    # preserve inclusion, so the lidar-frame test equals the devkit's
    # global-frame one.
    racks = [g for g in out if g["category"] == "static_object.bicycle_rack"]
    for g in out:
        g["in_bikerack"] = bool(racks) and point_in_any_box(
            np.asarray(g["center"]), racks)
    return out


def point_in_any_box(p: np.ndarray, boxes: List[Dict]) -> bool:
    """Devkit `points_in_box` semantics for one point: inside the yaw-rotated
    3D box (x extent = l/2, y = w/2, z = h/2 in the box frame)."""
    for b in boxes:
        c = np.asarray(b["center"], np.float64)
        w, l, h = b["wlh"]
        d = p - c
        cs, sn = np.cos(-b["yaw"]), np.sin(-b["yaw"])
        lx = cs * d[0] - sn * d[1]
        ly = sn * d[0] + cs * d[1]
        if abs(lx) <= l / 2 and abs(ly) <= w / 2 and abs(d[2]) <= h / 2:
            return True
    return False


def bikerack_boxes(gt_anno: List[Dict]) -> np.ndarray:
    """[K, 7] (x, y, z, w, l, h, yaw) lidar-frame bike-rack boxes from a
    baked `gt_anno` record — the eval side needs them to apply the devkit's
    bike-rack filter to PREDICTIONS as well as GT."""
    racks = [g for g in gt_anno
             if g.get("category") == "static_object.bicycle_rack"]
    if not racks:
        return np.zeros((0, 7), np.float32)
    return np.asarray(
        [list(g["center"]) + list(g["wlh"]) + [g["yaw"]] for g in racks],
        np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--infos", required=True, help="existing mmdet3d-style info pkl")
    ap.add_argument("--out", required=True)
    ap.add_argument("--nsweeps", type=int, default=5)
    args = ap.parse_args()

    tables = Tables(args.dataroot, args.version)
    with open(args.infos, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data

    for i, info in enumerate(infos):
        tok = info["token"]
        info["radar_points"] = aggregate_radar(tables, tok, args.nsweeps)
        info["sweeps_cam"] = collect_camera_sweeps(tables, tok)
        info["gt_anno"] = collect_gt(tables, tok)
        # lidar-frame bike-rack boxes for the devkit's prediction-side
        # bike-rack filter (GT carries per-box `in_bikerack` flags)
        info["bikeracks"] = bikerack_boxes(info["gt_anno"])
        info.setdefault("scene_token",
                        tables.sample.get(tok, {}).get("scene_token", ""))
        # ego origin in the lidar (box) frame: the devkit measures eval
        # distance filters from the EGO pose, not the lidar origin (~1 m xy
        # offset) — eval/metrics.py consumes this as `ego_xy`
        lidar_sd = tables.sample_data[tables.sample_to_sd[tok]["LIDAR_TOP"]]
        cs = tables.calibrated_sensor[lidar_sd["calibrated_sensor_token"]]
        ego2lidar = transform_matrix(cs["translation"], cs["rotation"],
                                     inverse=True)
        info["ego2lidar_xy"] = ego2lidar[:2, 3].astype(np.float32)
        # radar for each sweep step too (history frames)
        for sw in info["sweeps_cam"]:
            sw.setdefault("radar_points", info["radar_points"])
        if i % 500 == 0:
            print(f"{i}/{len(infos)}")

    with open(args.out, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": args.version}}, f)
    print(f"wrote {len(infos)} infos -> {args.out}")


if __name__ == "__main__":
    main()
