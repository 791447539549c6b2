"""Host-side geometric augmentation.

`ImageAug` mirrors `RandomTransformImage`
(the reference's `loaders/pipelines/transforms.py:219-342`, BEVStereo-style):
random resize in [0.38, 0.55], crop to the final 256x704, optional horizontal
flip; the resulting 2D transform right-multiplies into every `lidar2img`
(`lidar2img <- ida_mat @ lidar2img`).

`bev_rot_scale_aug` mirrors `RaCGlobalRotScaleTransImage`
(`transforms.py:397-464`): global BEV yaw rotation and scale applied to GT
boxes, lidar and radar points, with the inverse transform folded into
`lidar2img`.

A copy of `racformer_tpu/data/transforms.py` (the port imports nothing of
the JAX package); `tests/test_torch_data.py` holds the copy equal to its
original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ImageAug:
    resize: float
    crop: Tuple[int, int, int, int]  # (x0, y0, x1, y1) in resized coords
    flip: bool
    final_dim: Tuple[int, int]

    @classmethod
    def sample(cls, rng: np.random.Generator, ida_cfg: dict, training: bool):
        fH, fW = ida_cfg["final_dim"]
        H, W = ida_cfg.get("src_dim", (900, 1600))
        bot_lim = ida_cfg.get("bot_pct_lim", (0.0, 0.0))
        if training:
            resize = rng.uniform(*ida_cfg["resize_lim"])
            newW, newH = int(W * resize), int(H * resize)
            # bottom-anchored crop (BEVStereo convention, ref transforms.py:325):
            # crop_h = (1 - u) * newH - fH with u ~ U(bot_pct_lim); at the
            # default (0, 0) this deterministically keeps the bottom fH rows.
            crop_h = int((1.0 - rng.uniform(*bot_lim)) * newH) - fH
            crop_w = int(rng.uniform(0, max(0, newW - fW)))
            flip = bool(ida_cfg.get("rand_flip", False) and rng.uniform() < 0.5)
        else:
            # test-time: exact max-fit resize, bottom crop centered horizontally
            # (ref transforms.py:333-337; the released ckpt was evaluated with
            # this exact crop, so no fudge terms).
            resize = max(fH / H, fW / W)
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1.0 - float(np.mean(bot_lim))) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            flip = False
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        return cls(resize=resize, crop=crop, flip=flip, final_dim=(fH, fW))

    def matrix(self) -> np.ndarray:
        """4x4 image-plane transform (ida_mat)."""
        fH, fW = self.final_dim
        M = np.eye(4, dtype=np.float32)
        M[0, 0] = M[1, 1] = self.resize
        M[0, 3] = -self.crop[0]
        M[1, 3] = -self.crop[1]
        if self.flip:
            F = np.eye(4, dtype=np.float32)
            F[0, 0] = -1.0
            # BEVStereo convention: x' = fW - x (ref transforms.py:294-296
            # uses b = crop[2]-crop[0]); the pixel mirror is fW-1-x, a
            # half-pixel quirk the trained checkpoints absorbed — match the
            # matrix, not the "cleaner" fW-1
            F[0, 3] = fW
            M = F @ M
        return M


def apply_image_aug(img: np.ndarray, aug: ImageAug) -> np.ndarray:
    """img: [H, W, 3] uint8 -> [fH, fW, 3] uint8."""
    # Pillow is imported here, so that importing this module needs none
    from PIL import Image

    H, W = img.shape[:2]
    newW, newH = int(W * aug.resize), int(H * aug.resize)
    im = Image.fromarray(img).resize((newW, newH), Image.BILINEAR).crop(aug.crop)
    if aug.flip:
        im = im.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(im)


def bev_rot_scale_aug(
    rng: np.random.Generator,
    rot_range=(-0.3925, 0.3925),
    scale_ratio_range=(0.95, 1.05),
):
    """Sample a global BEV transform. Returns (T [4, 4], angle, scale):
    apply T to points/boxes, and `lidar2img <- lidar2img @ inv(T)`."""
    ang = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_ratio_range)
    c, s = np.cos(ang), np.sin(ang)
    T = np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
    ) * np.array([scale, scale, scale, 1.0], np.float32)[None, :]
    T[3, 3] = 1.0
    return T, ang, scale


def transform_boxes_bev(boxes: np.ndarray, T: np.ndarray, ang: float, scale: float):
    """boxes: [G, 9] raw (xyz, wlh, yaw, vx, vy) under global rot+scale."""
    out = boxes.copy()
    xyz1 = np.concatenate([boxes[:, :3], np.ones_like(boxes[:, :1])], 1)
    out[:, :3] = (xyz1 @ T.T)[:, :3]
    out[:, 3:6] *= scale
    out[:, 6] += ang
    vel = boxes[:, 7:9]
    R = T[:2, :2]
    out[:, 7:9] = vel @ R.T
    return out
