"""nuScenes multi-camera + radar dataset reader.

Capability match for `CustomNuScenesDataset_radar` + the loading pipelines
(the reference's `loaders/nuscenes_dataset.py:274-341`,
the reference's `loaders/pipelines/loading.py:603-954`), redesigned around
*precomputed* per-frame radar point records in the info pkl: the reference
constructs a `NuScenes` devkit instance at import time and aggregates radar
sweeps on the fly in every dataloader worker (`nuscenes_dataset.py:20-21,
346-493`) — an API wart SURVEY.md flags; `tools/gen_sweep_info.py` here bakes
those points into the infos instead.

Info schema per sample (dict):
  token, timestamp, lidar_path,
  cams: {name: {data_path, lidar2img [4,4] or (sensor2lidar_rotation,
        sensor2lidar_translation, cam_intrinsic), timestamp}},
  sweeps: list of history frames, each {cams: {...}, timestamp, radar_points}
  radar_points: [P, 7] float32 (x, y, z, rcs, vx_comp, vy_comp, t_lag),
  gt_boxes: [G, 9], gt_labels: [G]  (train)

Output batches are fixed-shape (padded radar points, padded GT), so every
step sees the same shapes.

A copy of `racformer_tpu/data/nuscenes.py` (the port imports nothing of the
JAX package); `tests/test_torch_data.py` holds the copy equal to its
original.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .depth_maps import points_to_depth_map, radar_to_depth_rcs_maps
from .transforms import (
    ImageAug, apply_image_aug, bev_rot_scale_aug, transform_boxes_bev,
)

DEFAULT_CAMERAS = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


def build_lidar2img(cam_info: Dict) -> np.ndarray:
    """Assemble lidar2img from sensor2lidar extrinsics + intrinsics
    (`loaders/nuscenes_dataset.py:236-266`)."""
    if "lidar2img" in cam_info:
        return np.asarray(cam_info["lidar2img"], np.float32)
    R = np.asarray(cam_info["sensor2lidar_rotation"], np.float64)
    t = np.asarray(cam_info["sensor2lidar_translation"], np.float64)
    lidar2cam = np.eye(4)
    lidar2cam[:3, :3] = R.T
    lidar2cam[:3, 3] = -R.T @ t
    K = np.asarray(cam_info["cam_intrinsic"], np.float64)
    viewpad = np.eye(4)
    viewpad[:3, :3] = K
    return (viewpad @ lidar2cam).astype(np.float32)


class NuScenesRadarDataset:
    def __init__(
        self,
        ann_file: str,
        num_frames: int = 8,
        frame_interval=6,
        camera_types: Sequence[str] = DEFAULT_CAMERAS,
        image_hw=(256, 704),
        ida_cfg: Optional[Dict] = None,
        bev_aug_cfg: Optional[Dict] = None,
        max_radar_points: int = 1536,
        max_gt: int = 64,
        training: bool = False,
        max_samples: Optional[int] = None,
        seed: int = 0,
    ):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        infos = sorted(infos, key=lambda x: x["timestamp"])
        if max_samples:
            infos = infos[:max_samples]
        self.infos = infos
        self.num_frames = num_frames
        self.frame_interval = frame_interval
        self.camera_types = list(camera_types)
        self.image_hw = image_hw
        self.ida_cfg = ida_cfg or dict(
            resize_lim=(0.38, 0.55), final_dim=image_hw,
            src_dim=(900, 1600), rand_flip=True,
        )
        self.bev_aug_cfg = bev_aug_cfg  # train-time global rot/scale; None = off
        self.max_radar_points = max_radar_points
        self.max_gt = max_gt
        self.training = training
        self.seed = seed

    def __len__(self):
        return len(self.infos)

    def _select_frames(self, info, rng) -> List[Dict]:
        """Current frame + history sweeps at the configured interval
        (train: random interval in `frame_interval` range, test: fixed —
        `loading.py:640-668`)."""
        frames = [info]
        sweeps = info.get("sweeps_cam", info.get("sweeps", []))
        if isinstance(self.frame_interval, (tuple, list)):
            interval = int(rng.integers(self.frame_interval[0], self.frame_interval[1] + 1))
        else:
            interval = int(self.frame_interval)
        idx = interval - 1
        for _ in range(self.num_frames - 1):
            if len(sweeps) == 0:
                frames.append(frames[-1])  # duplicate-pad when no history
                continue
            frames.append(sweeps[min(idx, len(sweeps) - 1)])
            idx += interval
        return frames

    def _rasterize_radar(self, pts, lidar2img, hw):
        """Radar depth/RCS column maps; native C++ rasterizer when built."""
        from . import native

        if native.available() and len(pts):
            from .depth_maps import project_to_image

            u, v, d = project_to_image(pts[:, :3], lidar2img)
            uvdr = np.stack([u, v, d, pts[:, 3]], 1).astype(np.float32)
            return native.radar_columns(uvdr, hw)
        return radar_to_depth_rcs_maps(pts, lidar2img, hw)

    def _load_image(self, path: str) -> np.ndarray:
        # BGR order to match the reference's cv2 loading (the model's
        # preprocessing converts BGR -> RGB on device). Uses the native
        # libjpeg decoder when available (csrc/dataloader.cpp), PIL otherwise.
        if path.lower().endswith((".jpg", ".jpeg")):
            from . import native

            if native.available():
                with open(path, "rb") as f:
                    rgb = native.decode_jpeg(f.read())
                if rgb is not None:
                    return rgb[..., ::-1]
        # Pillow is imported here, so that importing this module needs none
        from PIL import Image

        rgb = np.asarray(Image.open(path).convert("RGB"))
        return rgb[..., ::-1]

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        info = self.infos[idx]
        frames = self._select_frames(info, rng)
        T, N = self.num_frames, len(self.camera_types)
        H, W = self.image_hw
        aug = ImageAug.sample(rng, self.ida_cfg, self.training)
        ida = aug.matrix()

        # global BEV rot/scale aug (`RaCGlobalRotScaleTransImage`,
        # the reference's loaders/pipelines/transforms.py:397-464): transforms
        # GT boxes (incl. velocity), lidar & radar point xyz — radar point
        # velocity dims stay untouched, matching the reference's LiDARPoints
        # container (`loading.py:806-807`, attribute_dims=None) — and folds
        # the inverse into every lidar2img. Depth/RCS rasterization below uses
        # the transformed points + matrices, so the maps are aug-invariant,
        # exactly as in the reference pipeline order (config `:204-221`).
        bev_T = np.eye(4, dtype=np.float32)
        bev_ang, bev_scale = 0.0, 1.0
        if self.training and self.bev_aug_cfg:
            bev_T, bev_ang, bev_scale = bev_rot_scale_aug(rng, **self.bev_aug_cfg)
        bev_T_inv = np.linalg.inv(bev_T).astype(np.float32)

        imgs = np.zeros((T, N, H, W, 3), np.float32)
        l2i = np.zeros((T, N, 4, 4), np.float32)
        timestamps = np.zeros((T, N), np.float64)
        radar_pts = np.zeros((T, self.max_radar_points, 7), np.float32)
        radar_msk = np.zeros((T, self.max_radar_points), bool)
        radar_depth = np.zeros((T, N, H, W), np.float32)
        radar_rcs = np.full((T, N, H, W), -1000.0, np.float32)

        for t, fr in enumerate(frames):
            cams = fr["cams"]
            pts = np.asarray(fr.get("radar_points", np.zeros((0, 7))), np.float32)
            if len(pts) and self.training and self.bev_aug_cfg:
                pts = pts.copy()
                pts[:, :3] = pts[:, :3] @ bev_T[:3, :3].T
            n = min(len(pts), self.max_radar_points)
            radar_pts[t, :n] = pts[:n]
            radar_msk[t, :n] = True
            for c, cam in enumerate(self.camera_types):
                ci = cams[cam]
                m = ida @ build_lidar2img(ci) @ bev_T_inv
                l2i[t, c] = m
                timestamps[t, c] = ci.get("timestamp", fr.get("timestamp", 0)) / 1e6
                if "data_path" in ci and ci["data_path"]:
                    imgs[t, c] = apply_image_aug(self._load_image(ci["data_path"]), aug)
                rd, rr = self._rasterize_radar(pts, m, (H, W))
                radar_depth[t, c] = rd
                radar_rcs[t, c] = rr

        time_diff = (timestamps[:1].mean(-1) - timestamps.mean(-1)).astype(np.float32)

        sample = dict(
            imgs=imgs,
            radar_points=radar_pts,
            radar_mask=radar_msk,
            radar_depth=radar_depth,
            radar_rcs=radar_rcs,
            lidar2img=l2i,
            img2lidar=np.linalg.inv(
                l2i + 1e-9 * np.eye(4, dtype=np.float32)
            ).astype(np.float32),
            time_diff=time_diff,
            token=info.get("token", str(idx)),
            timestamp=np.float64(info.get("timestamp", 0)) / 1e6,
            scene=str(info.get("scene_token", "")),
            # ego origin in the lidar frame (gen_sweep_info bakes it); the
            # devkit measures eval range filters from the ego pose
            ego_xy=np.asarray(info.get("ego2lidar_xy", (0.0, 0.0)),
                              np.float32),
        )

        # GT comes along whenever the infos carry it (eval needs it for
        # metrics; the reference gets eval GT from the devkit, `val.py:19-51`)
        if "gt_boxes" in info:
            G = self.max_gt
            gt = np.asarray(info["gt_boxes"], np.float32)
            labels = np.asarray(info["gt_labels"], np.int64)
            n = min(len(gt), G)

            # attribute + point-count protocol fields from the baked
            # annotation record (tools/gen_sweep_info.py collect_gt),
            # aligned to the RAW (pre-augmentation) boxes by nearest BEV-xy
            # center — xy only because some pkl conventions store
            # bottom-center z while the tables carry gravity center. Always
            # emitted (filled -1) so batch collation stays key-stable.
            gta = np.full((G,), -1, np.int32)
            gtp = np.full((G,), -1, np.int32)
            gtr = np.full((G,), -1, np.int32)  # in_bikerack (-1 = unknown)
            anno = info.get("gt_anno")
            if anno and n:
                from ..tools.gen_sweep_info import ATTRIBUTES

                centers = np.asarray([a["center"] for a in anno], np.float32)
                gt_vel = np.zeros((n, 2), np.float32)
                has_vel = gt.shape[1] >= 9
                for j in range(n):
                    d = np.linalg.norm(centers[:, :2] - gt[j, :2], axis=-1)
                    k = int(np.argmin(d))
                    if d[k] < 0.5:
                        name = anno[k].get("attribute", "")
                        gta[j] = (ATTRIBUTES.index(name)
                                  if name in ATTRIBUTES else -1)
                        lp = anno[k].get("num_lidar_pts", -1)
                        rp = anno[k].get("num_radar_pts", -1)
                        gtp[j] = (lp + rp) if lp >= 0 and rp >= 0 else -1
                        if "in_bikerack" in anno[k]:
                            gtr[j] = int(bool(anno[k]["in_bikerack"]))
                        gt_vel[j] = anno[k].get("velocity", (0.0, 0.0))
                if not has_vel:
                    # 7-dim pkl boxes: backfill velocity from the tables so
                    # mAVE (and the training velocity target) is real
                    gt = np.concatenate([gt[:, :7], np.zeros(
                        (len(gt), 2), np.float32)], axis=1)
                    gt[:n, 7:9] = gt_vel

            if len(gt) and gt.shape[1] < 9:  # transform/pad expect 9 cols
                gt = np.concatenate(
                    [gt, np.zeros((len(gt), 9 - gt.shape[1]), np.float32)], 1)
            if len(gt) and self.training and self.bev_aug_cfg:
                gt = transform_boxes_bev(gt, bev_T, bev_ang, bev_scale)
            gtb = np.zeros((G, 9), np.float32)
            gtl = np.zeros((G,), np.int32)
            gtm = np.zeros((G,), bool)
            if n:
                gtb[:n, : gt.shape[1]] = gt[:n, :9]
                gtl[:n] = labels[:n]
                gtm[:n] = True
            # fixed-capacity bike-rack boxes (w <= 0 marks padding rows) so
            # batch collation stays shape-stable; eval applies the devkit's
            # prediction-side bike-rack filter from these
            racks = np.asarray(info.get("bikeracks", np.zeros((0, 7))),
                               np.float32).reshape(-1, 7)[:8]
            rpad = np.zeros((8, 7), np.float32)
            rpad[: len(racks)] = racks
            sample.update(gt_bboxes=gtb, gt_labels=gtl, gt_mask=gtm,
                          gt_attrs=gta, gt_num_pts=gtp, gt_in_bikerack=gtr,
                          gt_bikeracks=rpad)
            if self.training and "lidar_points" in info:
                pts = np.asarray(info["lidar_points"], np.float32)
                if len(pts) and self.bev_aug_cfg:
                    pts = pts.copy()
                    pts[:, :3] = pts[:, :3] @ bev_T[:3, :3].T
                dep = np.stack(
                    [points_to_depth_map(pts[:, :3], l2i[0, c], (H, W)) for c in range(N)]
                )
                sample["gt_depth"] = dep
        return sample

    def batch(self, indices):
        from .collate import collate

        return collate([self[i] for i in indices])
