"""RaCFormer detection head, eval path (port of `racformer_tpu/nn/head.py`
without query denoising): 900 queries = 150 rays x 6 distance clusters on
concentric rings, the weight-shared polar decoder, and the output boxes
reassembled into the 10-dim normalized layout
[cx, cy, log w, log l, cz, log h, sin, cos, vx, vy] with metric centers."""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from .decoder import RaCFormerDecoder

CODE_WEIGHTS = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def ring_points(num_query: int, num_clusters: int) -> torch.Tensor:
    """[Q, 2] (theta, d) ring layout."""
    num_angles = num_query // num_clusters
    angles = torch.linspace(0.0, 1.0, num_angles + 1)[:-1]
    dists = torch.linspace(0.0, 1.0, num_clusters + 2)[1:-1]
    return torch.stack([angles[:, None].expand(num_angles, num_clusters),
                        dists[None, :].expand(num_angles, num_clusters)],
                       dim=-1).reshape(-1, 2)


class RaCFormerHead(nn.Module):
    def __init__(self, num_classes: int = 10, num_query: int = 900,
                 num_clusters: int = 6, embed_dims: int = 256,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 decoder_cfg: Optional[dict[str, Any]] = None):
        super().__init__()
        self.num_classes, self.num_query = num_classes, num_query
        self.num_clusters, self.embed_dims = num_clusters, embed_dims
        self.pc_range = tuple(pc_range)
        # training-loss weights; stored because the reference checkpoint has them
        self.register_buffer("code_weights", torch.tensor(CODE_WEIGHTS))
        self.init_query_bbox = nn.Embedding(num_query, 10)
        self.label_enc = nn.Embedding(num_classes + 1, embed_dims - 1)
        self.transformer = nn.Module()  # reference nesting: transformer.decoder
        self.transformer.decoder = RaCFormerDecoder(**(decoder_cfg or {}))
        self.reset_query_bbox()

    @torch.no_grad()
    def reset_query_bbox(self, generator: Optional[torch.Generator] = None):
        """Reference init: N(0, 1), then z = 0.5, log h = 0.2, v = 0 and
        (theta, d) on the ring layout."""
        w = self.init_query_bbox.weight
        w.copy_(torch.randn(w.shape, generator=generator).to(w.device))
        w[:, 2] = 0.5
        w[:, 5] = 0.2
        w[:, 8:10] = 0.0
        w[:, :2] = ring_points(self.num_query, self.num_clusters).to(w.device)

    def forward(self, feat_cat, lss_bev, radar_bev, lidar2img, time_diff):
        """Returns {'all_cls_scores' [Lyr, B, Q, cls],
        'all_bbox_preds' [Lyr, B, Q, 10]}."""
        B = lss_bev.shape[0]
        Q, C = self.num_query, self.embed_dims
        query_bbox = self.init_query_bbox.weight[None].expand(B, Q, 10)
        base = torch.cat([self.label_enc.weight[self.num_classes],
                          self.label_enc.weight.new_zeros(1)])
        query_feat = base[None, None].expand(B, Q, C)
        cls_scores, bbox_preds = self.transformer.decoder(
            query_bbox, query_feat, feat_cat, lss_bev, radar_bev, lidar2img,
            time_diff)
        lo = torch.tensor(self.pc_range[0:3], device=bbox_preds.device)
        hi = torch.tensor(self.pc_range[3:6], device=bbox_preds.device)
        xyz = bbox_preds[..., 0:3] * (hi - lo) + lo
        bbox_preds = torch.cat([xyz[..., 0:2], bbox_preds[..., 3:5],
                                xyz[..., 2:3], bbox_preds[..., 5:10]], dim=-1)
        return {"all_cls_scores": cls_scores, "all_bbox_preds": bbox_preds}
