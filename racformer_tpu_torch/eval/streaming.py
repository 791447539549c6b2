"""Streaming inference with a per-frame feature cache on the device (port of
`racformer_tpu/eval/streaming.py`: `StreamingEvaluator.__init__`, `reset`
and `step`).

The cache is a T-frame window of encoded features (newest frame at index 0):
the level-concatenated image pyramid, the LSS and radar BEV maps, the
lidar2img matrices and the timestamps. Each step encodes only the new frame,
shifts the window, decodes it and decodes the boxes. The first frame of a
scene fills the whole window (the reference pads missing history with the
first frame).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..model.racformer import RaCFormer, preprocess_images
from .decode import decode_boxes


class StreamingEvaluator:
    def __init__(self, model: RaCFormer, eval_cfg: Optional[Dict] = None):
        self.model = model
        self.T = model.num_frames
        self.device = next(model.parameters()).device
        self.cache = None  # (feat_cat, lss, radar, lidar2img, ts), [1, T, ...]
        ecfg = eval_cfg or {}
        self.decode_cfg = dict(
            max_num=ecfg.get("max_num", 300),
            score_threshold=ecfg.get("score_threshold", 0.05),
            post_center_range=tuple(ecfg.get(
                "post_center_range", (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0))),
            legacy_version=ecfg.get("legacy_version", "v1.0.0"))

    def reset(self):
        """Call at scene boundaries (a new scene must not see old frames)."""
        self.cache = None

    def _window(self, new: torch.Tensor, old: Optional[torch.Tensor]):
        """[1, ...] newest frame + [1, T, ...] window -> shifted window."""
        if old is None:
            return new[:, None].expand(1, self.T, *new.shape[1:]).contiguous()
        return torch.cat([new[:, None], old[:, : self.T - 1]], dim=1)

    @torch.no_grad()
    def step(self, frame: Dict, blocking: bool = True) -> Dict:
        """frame: imgs [N, H, W, 3] (raw 0-255, uint8 preferred), radar_points
        [P, 7], radar_mask [P], radar_depth / radar_rcs [N, H, W] dense maps
        or [N, W] column maps, lidar2img [N, 4, 4], img2lidar [N, 4, 4], and
        timestamp (float seconds RELATIVE to the scene start: float32 cannot
        resolve sub-second deltas at epoch magnitudes).

        Returns the decoded boxes of the current frame: numpy arrays when
        `blocking`, device tensors otherwise."""
        if abs(float(frame["timestamp"])) > 1e6:
            raise ValueError(
                "timestamp looks absolute (epoch seconds); pass scene-relative "
                "seconds")
        dev = self.device

        def b(key):
            return torch.as_tensor(np.asarray(frame[key])).to(dev)[None]

        imgs = preprocess_images(b("imgs"))
        H = imgs.shape[2]
        radar = []
        for key in ("radar_depth", "radar_rcs"):
            m = b(key).float()
            if m.dim() == 3:  # column form [1, N, W]: the rasterizer smears columns
                m = m[:, :, None, :].expand(m.shape[0], m.shape[1], H, m.shape[2])
            radar.append(m)
        feat_cat, lss, rbev, _ = self.model.encode_frame(
            imgs, b("radar_points").float(), b("radar_mask").bool(), radar[0],
            radar[1], b("img2lidar").float())
        l2i = b("lidar2img").float()
        ts = torch.tensor([float(frame["timestamp"])], dtype=torch.float32,
                          device=dev)
        old = self.cache or (None,) * 5
        self.cache = tuple(self._window(new, o) for new, o in
                           zip((feat_cat, lss, rbev, l2i, ts), old))
        cat_w, lss_w, radar_w, l2i_w, ts_w = self.cache
        time_diff = ts_w[:, :1] - ts_w
        outs = self.model.decode_window(cat_w, lss_w, radar_w, l2i_w, time_diff)
        out = decode_boxes(outs["all_cls_scores"][-1],
                           outs["all_bbox_preds"][-1], **self.decode_cfg)
        if blocking:
            return {k: v.cpu().numpy() for k, v in out.items()}
        return out
