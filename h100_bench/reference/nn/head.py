"""RaCFormer detection head (port of `racformer_tpu/nn/head.py`): 900
queries = 150 rays x 6 distance clusters on concentric rings, query
denoising (DN) in training, the weight-shared polar decoder, and the output
boxes reassembled into the 10-dim normalized layout
[cx, cy, log w, log l, cz, log h, sin, cos, vx, vy] with metric centers.

Query denoising follows the JAX package's static form: `max_gt` GT slots per
sample in each of `dn_groups` noise groups, invalid slots masked. Its random
draws are made by `dn_draws` from an explicit generator and passed in, so a
caller (or a test) can hold them fixed.

The query features start in `dtype` (the head's compute dtype: the label
embedding's rows in it, as the JAX head's `label_enc`); the query boxes are
float32."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..ops.bbox_codec import encode_bbox, xy_to_theta_d
from .decoder import RaCFormerDecoder
from .layers import Embedding

CODE_WEIGHTS = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
DN_BOX_NOISE = 0.5  # the JAX head's dn_bbox_noise_scale
DN_LABEL_NOISE = 0.5  # and its dn_label_noise_scale


def ring_points(num_query: int, num_clusters: int) -> torch.Tensor:
    """[Q, 2] (theta, d) ring layout."""
    num_angles = num_query // num_clusters
    angles = torch.linspace(0.0, 1.0, num_angles + 1)[:-1]
    dists = torch.linspace(0.0, 1.0, num_clusters + 2)[1:-1]
    return torch.stack([angles[:, None].expand(num_angles, num_clusters),
                        dists[None, :].expand(num_angles, num_clusters)],
                       dim=-1).reshape(-1, 2)


def dn_attn_mask(pad_size: int, single_pad: int, num_groups: int,
                 num_query: int, device=None) -> torch.Tensor:
    """Group-blocked self-attention mask [pad + Q, pad + Q], True = blocked:
    matching queries see no DN query, and each DN group sees only itself
    and the matching queries."""
    total = pad_size + num_query
    mask = torch.zeros((total, total), dtype=torch.bool, device=device)
    mask[pad_size:, :pad_size] = True
    for g in range(num_groups):
        lo, hi = single_pad * g, single_pad * (g + 1)
        mask[lo:hi, hi:pad_size] = True
        mask[lo:hi, :lo] = True
    return mask


def dn_draws(batch: int, max_gt: int, dn_groups: int, num_classes: int,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The random draws of query denoising, as the JAX `_dn_prepare` makes
    them: box noise `rand` U(-1, 1) [B, groups, G, 3], label `flip` (with
    probability DN_LABEL_NOISE) [B, groups, G] and the random labels
    `rand_lab` [B, groups, G], on the generator's device."""
    shape = (batch, dn_groups, max_gt)
    return {
        "rand": torch.rand(shape + (3,), generator=generator) * 2.0 - 1.0,
        "flip": torch.rand(shape, generator=generator) < DN_LABEL_NOISE,
        "rand_lab": torch.randint(0, num_classes, shape, generator=generator),
    }


class RaCFormerHead(nn.Module):
    def __init__(self, num_classes: int = 10, num_query: int = 900,
                 num_clusters: int = 6, embed_dims: int = 256,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 decoder_cfg: Optional[dict[str, Any]] = None,
                 query_denoising: bool = True, dn_groups: int = 10,
                 max_gt: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.num_query = num_classes, num_query
        self.num_clusters, self.embed_dims = num_clusters, embed_dims
        self.pc_range = tuple(pc_range)
        self.query_denoising, self.dn_groups = query_denoising, dn_groups
        self.max_gt = max_gt
        # training-loss weights; stored because the reference checkpoint has them
        self.register_buffer("code_weights", torch.tensor(CODE_WEIGHTS))
        self.init_query_bbox = nn.Embedding(num_query, 10)
        self.label_enc = Embedding(num_classes + 1, embed_dims - 1, dtype)
        self.transformer = nn.Module()  # reference nesting: transformer.decoder
        self.transformer.decoder = RaCFormerDecoder(
            **{**(decoder_cfg or {}), "dtype": dtype})
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

    def _dn_prepare(self, gt_bboxes, gt_labels, gt_mask, draws):
        """Noised DN queries from the GT boxes [B, G, 9], labels [B, G] and
        validity [B, G] with the draws of `dn_draws`. Returns (dn_bbox
        [B, S, 10], dn_labels [B, S], dn_valid [B, S]), S = dn_groups * G."""
        B, G, _ = gt_bboxes.shape
        ng = self.dn_groups
        wlh = gt_bboxes[..., 3:6]
        enc = xy_to_theta_d(encode_bbox(gt_bboxes, self.pc_range))
        e = enc[:, None].expand(B, ng, G, enc.shape[-1])
        w2 = wlh[:, None].expand(B, ng, G, 3)
        rand = draws["rand"]
        r = 65.0
        scale = DN_BOX_NOISE
        diag = torch.sqrt(w2[..., 0:1] ** 2 + w2[..., 1:2] ** 2)
        arc_ratio = diag / (2.0 * math.pi * e[..., 1:2].clamp(min=1e-4) * r)
        theta_delta = rand[..., 0:1] * (arc_ratio / 2.0) * scale * e[..., 1:2]
        d_delta = rand[..., 1:2] * diag / (r * 2.0) * scale
        z_delta = rand[..., 2:3] * w2[..., 2:3] / 16.0 * scale
        theta = e[..., 0:1] + theta_delta
        theta = torch.remainder((theta + 1.0) * 2.0 * math.pi,
                                2.0 * math.pi) / (2.0 * math.pi)
        noised = torch.cat([theta, e[..., 1:2] + d_delta,
                            e[..., 2:3] + z_delta, e[..., 3:]], dim=-1)
        noised = torch.cat([noised[..., 0:3].clamp(0.0, 1.0), noised[..., 3:]],
                           dim=-1)
        labels = gt_labels[:, None].expand(B, ng, G)
        labels = torch.where(draws["flip"], draws["rand_lab"].to(labels.dtype),
                             labels)
        valid = gt_mask[:, None].expand(B, ng, G)
        noised = torch.where(valid[..., None], noised,
                             torch.zeros_like(noised)).reshape(B, ng * G, -1)
        labels = torch.where(valid, labels,
                             torch.full_like(labels, self.num_classes))
        return noised, labels.reshape(B, ng * G), valid.reshape(B, ng * G)

    def forward(self, feat_cat, lss_bev, radar_bev, lidar2img, time_diff,
                gt_bboxes=None, gt_labels=None, gt_mask=None, dn=None):
        """Returns {'all_cls_scores' [Lyr, B, Q, cls],
        'all_bbox_preds' [Lyr, B, Q, 10]}; in train mode with ground truth
        and the DN draws `dn` (`dn_draws`), also 'dn_cls_scores',
        'dn_bbox_preds' [Lyr, B, S, .] and 'dn_valid' [B, S]."""
        B = lss_bev.shape[0]
        Q, C = self.num_query, self.embed_dims
        query_bbox = self.init_query_bbox.weight[None].expand(B, Q, 10)
        dt = self.label_enc.compute_dtype
        base = self.label_enc.weight[self.num_classes].to(dt)
        base = torch.cat([base, base.new_zeros(1)])
        query_feat = base[None, None].expand(B, Q, C)
        attn_mask, S = None, 0
        use_dn = (self.training and self.query_denoising
                  and gt_bboxes is not None)
        if use_dn:
            if dn is None:
                raise ValueError("query denoising in train mode needs the "
                                 "draws `dn` (nn.head.dn_draws)")
            dn_bbox, dn_labels, dn_valid = self._dn_prepare(
                gt_bboxes, gt_labels, gt_mask, dn)
            S = dn_bbox.shape[1]
            dn_feat = self.label_enc(dn_labels.long())
            dn_feat = torch.cat([dn_feat, dn_feat.new_ones(B, S, 1)], dim=-1)
            dn_feat = torch.where(dn_valid[..., None], dn_feat,
                                  torch.zeros_like(dn_feat))
            query_bbox = torch.cat([dn_bbox, query_bbox], dim=1)
            query_feat = torch.cat([dn_feat, query_feat], dim=1)
            attn_mask = dn_attn_mask(S, gt_bboxes.shape[1], self.dn_groups, Q,
                                     device=query_feat.device)
        cls_scores, bbox_preds = self.transformer.decoder(
            query_bbox, query_feat, feat_cat, lss_bev, radar_bev, lidar2img,
            time_diff, attn_mask)
        lo = torch.tensor(self.pc_range[0:3], device=bbox_preds.device)
        hi = torch.tensor(self.pc_range[3:6], device=bbox_preds.device)
        xyz = bbox_preds[..., 0:3] * (hi - lo) + lo
        bbox_preds = torch.cat([xyz[..., 0:2], bbox_preds[..., 3:5],
                                xyz[..., 2:3], bbox_preds[..., 5:10]], dim=-1)
        outs = {"all_cls_scores": cls_scores[:, :, S:],
                "all_bbox_preds": bbox_preds[:, :, S:]}
        if use_dn:
            outs["dn_cls_scores"] = cls_scores[:, :, :S]
            outs["dn_bbox_preds"] = bbox_preds[:, :, :S]
            outs["dn_valid"] = dn_valid
        return outs
