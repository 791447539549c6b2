"""The streams' windows, rebuilt from their frames, through the reference.

The port's streaming evaluator keeps a T-frame window of encoded features,
newest first, and a new scene fills the whole window with its first frame.
So the window of the frame at step t of a scene that began at step s holds,
in slot j, the frame of step max(t - j, s). Here each step's frames are
encoded once, and the streams' windows assembled from those encodes are
decoded together, both batched as the evaluator batches them; the last
decoder layer's class logits and boxes are returned with the decoded
boxes.
"""

from __future__ import annotations

import numpy as np
import torch

from .eval.decode import decode_boxes
from .model.racformer import preprocess_images

FIELDS = ("imgs", "radar_points", "radar_mask", "radar_depth", "radar_rcs",
          "lidar2img", "img2lidar")


class WindowReference:
    """`tapes`: one list a stream of (pool index, scene start, timestamp)
    per step."""

    def __init__(self, model, pool, tapes, decode_cfg, device):
        self.model, self.pool, self.tapes = model, pool, tapes
        self.device, self.decode_cfg = device, decode_cfg
        self.encodes = {}

    @torch.no_grad()
    def encode(self, k):
        """Step k's frames of every stream, encoded as one batch."""
        if k not in self.encodes:
            frames = [self.pool[t[k][0]] for t in self.tapes]
            f = {n: torch.from_numpy(np.stack([np.asarray(x[n]) for x in frames]))
                 .to(self.device) for n in FIELDS}
            imgs = preprocess_images(f["imgs"])
            B, H = imgs.shape[0], imgs.shape[2]
            maps = []
            for n in ("radar_depth", "radar_rcs"):
                m = f[n].float()
                if m.dim() == 3:  # column form [B, N, W]
                    m = m[:, :, None, :].expand(B, m.shape[1], H, m.shape[2])
                maps.append(m)
            cat, lss, rbev, _ = self.model.encode_frame(
                imgs, f["radar_points"].float(), f["radar_mask"].bool(),
                maps[0], maps[1], f["img2lidar"].float())
            self.encodes[k] = (cat, lss, rbev, f["lidar2img"].float())
        return self.encodes[k]

    def slots(self, b, i):
        """The T (step, timestamp) slots of stream b's window at step i,
        newest first."""
        tape, s = self.tapes[b], i
        while not tape[s][1]:
            s -= 1
        T = self.model.num_frames
        return [(max(i - j, s), tape[max(i - j, s)][2]) for j in range(T)]

    @torch.no_grad()
    def window(self, i):
        """Every stream's window at step i, decoded as one batch: (class
        logits [B, Q, C], boxes [B, Q, 10], decoded dict) of the head's
        last layer."""
        slots = [self.slots(b, i) for b in range(len(self.tapes))]
        self.forget({k for sl in slots for k, _ in sl})
        cat, lss, rbev, l2i = (torch.stack([torch.stack(
            [self.encode(k)[n][b] for k, _ in sl]) for b, sl in enumerate(slots)])
            for n in range(4))
        ts = torch.tensor([[t for _, t in sl] for sl in slots],
                          dtype=torch.float32, device=self.device)
        outs = self.model.decode_window(cat, lss, rbev, l2i, ts[:, :1] - ts)
        cls, box = outs["all_cls_scores"][-1], outs["all_bbox_preds"][-1]
        return cls.float(), box.float(), decode_boxes(cls, box, **self.decode_cfg)

    def forget(self, keep):
        """Drop the encodes of steps not in `keep`."""
        for k in [k for k in self.encodes if k not in keep]:
            del self.encodes[k]
