"""View-of-Delft (VoD) mono-camera + 4D-radar dataset.

Capability match for `VoDMonoDataset`
(the reference's `loaders/vod_mono_dataset.py:17-677`): KITTI-format infos
(calib P2 / Tr_velo_to_cam, camera-frame annotations for Car / Pedestrian /
Cyclist), 5-frame-accumulated 4D radar point clouds with 7 features, and
KITTI-protocol evaluation (see `eval/kitti_eval.py`).

Adapted to this framework's batch schema: num_cams=1, num_frames=1 (VoD is
single-frame mono), radar points in the camera-aligned lidar frame.

A copy of `racformer_tpu/data/vod.py` (the port imports nothing of the JAX
package); `tests/test_torch_data.py` holds the copy equal to its original.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

VOD_CLASSES = ("Car", "Pedestrian", "Cyclist")


def read_radar_points(path: str, num_features: int = 7) -> np.ndarray:
    """VoD radar .bin: float32 rows of (x, y, z, RCS, v_r, v_r_comp, time)."""
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, num_features)


class VoDDataset:
    def __init__(
        self,
        info_file: str,
        data_root: str = "",
        image_hw=(256, 704),
        max_radar_points: int = 1024,
        max_gt: int = 32,
        training: bool = False,
        max_samples: Optional[int] = None,
    ):
        with open(info_file, "rb") as f:
            infos = pickle.load(f)
        if isinstance(infos, dict):
            infos = infos.get("infos", infos)
        if max_samples:
            infos = infos[:max_samples]
        self.infos = infos
        self.data_root = data_root
        self.image_hw = image_hw
        self.max_radar_points = max_radar_points
        self.max_gt = max_gt
        self.training = training

    def __len__(self):
        return len(self.infos)

    def _lidar2img(self, info) -> np.ndarray:
        calib = info["calib"]
        P2 = np.asarray(calib["P2"], np.float64)  # [3, 4] or [4, 4]
        if P2.shape == (3, 4):
            P2 = np.vstack([P2, [0, 0, 0, 1]])
        Trv2c = np.asarray(calib.get("Tr_velo_to_cam", np.eye(4)), np.float64)
        if Trv2c.shape == (3, 4):
            Trv2c = np.vstack([Trv2c, [0, 0, 0, 1]])
        R0 = np.asarray(calib.get("R0_rect", np.eye(4)), np.float64)
        if R0.shape == (3, 3):
            R0_ = np.eye(4)
            R0_[:3, :3] = R0
            R0 = R0_
        return (P2 @ R0 @ Trv2c).astype(np.float32)

    def __getitem__(self, idx) -> Dict:
        info = self.infos[idx]
        H, W = self.image_hw
        img_info = info.get("image", {})
        img_path = img_info.get("image_path")
        img = np.zeros((H, W, 3), np.float32)
        scale = 1.0
        if img_path:
            full = os.path.join(self.data_root, img_path)
            if os.path.exists(full):
                # imported here: importing the module needs no Pillow
                from PIL import Image

                im = Image.open(full).convert("RGB")
                scale = min(H / im.height, W / im.width)
                im = im.resize((int(im.width * scale), int(im.height * scale)),
                               Image.BILINEAR)
                arr = np.asarray(im)[..., ::-1]  # BGR
                img[: arr.shape[0], : arr.shape[1]] = arr

        l2i = self._lidar2img(info)
        S = np.diag([scale, scale, 1.0, 1.0]).astype(np.float32)
        l2i = S @ l2i

        # radar points (5-frame accumulated file per the reference's
        # `pts_radar_prefix = 'radar_5frames/...'`)
        P = self.max_radar_points
        pts = np.zeros((P, 7), np.float32)
        mask = np.zeros((P,), bool)
        rp = info.get("radar_path")
        if rp:
            full = os.path.join(self.data_root, rp)
            if os.path.exists(full):
                raw = read_radar_points(full)
                n = min(len(raw), P)
                pts[:n] = raw[:n]
                mask[:n] = True

        # rasterize the radar hits into the column-smeared depth/RCS maps the
        # radar-assisted DepthNet consumes (same op as nuScenes,
        # ref `loaders/pipelines/loading.py:522-548`)
        from .depth_maps import radar_to_depth_rcs_maps

        dmap, rmap = radar_to_depth_rcs_maps(pts[mask], l2i, (H, W))

        sample = dict(
            imgs=img[None, None],  # [T=1, N=1, H, W, 3]
            radar_points=pts[None],
            radar_mask=mask[None],
            radar_depth=dmap[None, None],
            radar_rcs=rmap[None, None],
            lidar2img=l2i[None, None],
            img2lidar=np.linalg.inv(l2i)[None, None].astype(np.float32),
            time_diff=np.zeros((1,), np.float32),
            token=str(info.get("image", {}).get("image_idx", idx)),
        )

        annos = info.get("annos")
        if annos is not None:
            G = self.max_gt
            names = np.asarray(annos["name"])
            keep = np.isin(names, VOD_CLASSES)
            loc = np.asarray(annos["location"], np.float32)[keep]
            dim = np.asarray(annos["dimensions"], np.float32)[keep]  # l, h, w
            ry = np.asarray(annos["rotation_y"], np.float32)[keep]
            labels = np.asarray(
                [VOD_CLASSES.index(n) for n in names[keep]], np.int32
            )
            n = min(len(loc), G)
            gtb = np.zeros((G, 9), np.float32)
            gtl = np.zeros((G,), np.int32)
            gtm = np.zeros((G,), bool)
            if n:
                # camera-frame KITTI boxes -> (x, y, z, w, l, h, yaw) layout
                gtb[:n, 0:3] = loc[:n]
                gtb[:n, 3] = dim[:n, 2]  # w
                gtb[:n, 4] = dim[:n, 0]  # l
                gtb[:n, 5] = dim[:n, 1]  # h
                gtb[:n, 6] = ry[:n]
                gtl[:n] = labels[:n]
                gtm[:n] = True
            sample.update(gt_bboxes=gtb, gt_labels=gtl, gt_mask=gtm)
        return sample

    def batch(self, indices):
        from .collate import collate

        return collate([self[i] for i in indices])
