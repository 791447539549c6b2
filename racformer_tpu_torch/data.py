"""Synthetic dataset: deterministic fake nuScenes-like samples (camera
geometry, radar returns, GT boxes, sparse depth), numpy only.

A copy of `racformer_tpu/data/synthetic.py`, so that the port's train path
runs without importing the JAX package; `tests/test_torch_train_parts.py`
holds the two equal sample for sample.
"""

from __future__ import annotations

import numpy as np


def surround_cameras(num_cams: int, hw=(256, 704), f=500.0):
    """lidar2img for num_cams cameras spread around the ego yaw circle."""
    H, W = hw
    mats = []
    for i in range(num_cams):
        yaw = 2 * np.pi * i / num_cams
        R = np.array([[-np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, -1.0],
                      [np.cos(yaw), np.sin(yaw), 0.0]], np.float32)
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = K @ R
        mats.append(M)
    return np.stack(mats)


class SyntheticDataset:
    def __init__(self, num_samples=8, num_cams=6, num_frames=8, hw=(256, 704),
                 max_radar_points=1536, max_gt=64, seed=0):
        self.num_samples = num_samples
        self.num_cams = num_cams
        self.num_frames = num_frames
        self.hw = hw
        self.max_radar_points = max_radar_points
        self.max_gt = max_gt
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100_003 + idx)
        T, N = self.num_frames, self.num_cams
        H, W = self.hw
        l2i = np.broadcast_to(surround_cameras(N, self.hw), (T, N, 4, 4)).copy()

        P = self.max_radar_points
        n_real = int(rng.integers(P // 4, P))
        pts = np.zeros((T, P, 7), np.float32)
        pts[:, :n_real, 0:2] = rng.uniform(-50, 50, size=(T, n_real, 2))
        pts[:, :n_real, 3] = rng.uniform(-20, 30, size=(T, n_real))
        pts[:, :n_real, 4:6] = rng.normal(size=(T, n_real, 2))
        mask = np.zeros((T, P), bool)
        mask[:, :n_real] = True

        G = self.max_gt
        n_gt = int(rng.integers(1, min(G, 24)))
        gt = np.zeros((G, 9), np.float32)
        gt[:n_gt, 0:2] = rng.uniform(-45, 45, size=(n_gt, 2))
        gt[:n_gt, 2] = rng.uniform(-2, 1, size=(n_gt,))
        gt[:n_gt, 3:6] = rng.uniform(0.5, 6.0, size=(n_gt, 3))
        gt[:n_gt, 6] = rng.uniform(-np.pi, np.pi, size=(n_gt,))
        gt_labels = np.zeros((G,), np.int32)
        gt_labels[:n_gt] = rng.integers(0, 10, size=(n_gt,))
        gt_mask = np.arange(G) < n_gt

        return dict(
            imgs=rng.uniform(0, 255, size=(T, N, H, W, 3)).astype(np.float32),
            radar_points=pts,
            radar_mask=mask,
            radar_depth=rng.uniform(0, 60, size=(T, N, H, W)).astype(np.float32),
            radar_rcs=rng.uniform(-40, 40, size=(T, N, H, W)).astype(np.float32),
            lidar2img=l2i,
            img2lidar=np.linalg.inv(l2i).astype(np.float32),
            time_diff=(np.arange(T, dtype=np.float32) * 0.5),
            gt_bboxes=gt,
            gt_labels=gt_labels,
            gt_mask=gt_mask,
            # sparse lidar-like depth: ~5% of pixels hit, rest 0 (a dense
            # uniform map would min-pool below d_lo and kill the depth loss)
            gt_depth=(rng.uniform(2, 60, size=(N, H, W))
                      * (rng.uniform(size=(N, H, W)) < 0.05)).astype(np.float32),
        )

    def batch(self, indices):
        samples = [self[i] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
