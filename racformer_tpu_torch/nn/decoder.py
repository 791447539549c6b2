"""RaCFormer query decoder (port of `racformer_tpu/nn/decoder.py`).

One decoder layer's weights are shared by all iterations (the reference's
weight sharing); the JAX package's `nn.scan` over the layer is a Python loop
here. Per iteration: polar position encoding, scale-adaptive self-attention,
the radar-BEV and LSS-BEV deformable samplers, the image radial sampler and
adaptive mixing, 3-way fusion, FFN, the cls / reg branches and the polar box
refinement with the per-iteration shrinking `d_region`. Work that is the
same in every iteration (radar ConvGRU temporal encoding, BEV positional
encodings and value projections) runs once, before the loop.

In train mode each iteration runs under `torch.utils.checkpoint`: its
activations are recomputed in the backward, as the JAX package's
`nn.remat` of the scanned layer does, under one of its remat policies
(`REMAT_POLICIES`, chosen by `remat_policy`: the config's
`decoder.remat_policy`, else `RACFORMER_REMAT_POLICY`, else "full"): a
policy other than "full" keeps some outputs of the forward through a
selective-checkpoint context instead of recomputing them. The iteration's
dropout masks come from a seed drawn before the checkpointed call, so the
recompute draws the same masks (`torch.utils.checkpoint` restores only the
global RNG state).
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.bbox_codec import inverse_sigmoid, theta_d_to_xy
from ..ops import bilinear
from .adaptive_mixing import AdaptiveMixing
from .bev_sampling import BEVSampling
from .conv_gru import RadarBEVTemporalEncoder
from .img_sampling import ImageRadialSampling
from .layers import (Dropout, DropoutRNG, Linear, current_dropout_rng,
                     dropout_rng, layer_norm)
from .sasa import ScaleAdaptiveSelfAttention

CLS_PRIOR_BIAS = -4.59511985013459  # bias_init_with_prob(0.01)

_aten = torch.ops.aten
# the matrix products as a dispatch mode sees them (`F.linear` reaches it
# as mm / addmm)
_DOTS = frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm})
# The JAX package's policies (`racformer_tpu/nn/decoder.py`), as what the
# forward keeps: (the matrix products whose outputs are kept, the sampler
# sites whose `patch_sample_op` outputs are kept). "dots" is
# `checkpoint_dots`, "dots_no_batch" `dots_with_no_batch_dims_saveable`
# (no batched products), "save_sampled" and "save_bev" keep what JAX tags
# "sampled_img" and "sampled_bev": the samples of the image site and the
# two BEV sites, so their K2 gathers are not run again in the backward.
REMAT_POLICIES = {
    "full": (frozenset(), ()),
    "dots": (_DOTS, ()),
    "dots_no_batch": (_DOTS - {_aten.bmm, _aten.baddbmm}, ()),
    "save_sampled": (frozenset(), ("img", "bev")),
    "save_bev": (frozenset(), ("bev",)),
}


def resolve_remat_policy(name: Optional[str] = None) -> str:
    """The policy's name: `name`, else `RACFORMER_REMAT_POLICY`, else
    "full"; an unknown one raises as the JAX package does."""
    name = name or os.environ.get("RACFORMER_REMAT_POLICY", "full")
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown decoder remat_policy {name!r}; "
                         f"expected one of {sorted(REMAT_POLICIES)}")
    return name


def _keeps(dots, sites, ctx, func, *args, **kwargs):
    if func.overloadpacket in dots or (func._schema.name == bilinear.OP_NAME
                                       and args[5] in sites):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(name: str):
    """`torch.utils.checkpoint`'s `context_fn` for policy `name` (None for
    "full", which keeps nothing)."""
    dots, sites = REMAT_POLICIES[name]
    if not dots and not sites:
        return None
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_keeps, dots, sites))


class FFN(nn.Module):
    """mmcv FFN with residual and dropout 0.1 after each linear; keys
    `layers.0.0` and `layers.1`."""

    def __init__(self, dims: int, hidden: int = 512):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(dims, hidden), nn.ReLU()), Linear(hidden, dims))
        self.dropout = Dropout(0.1)

    def forward(self, x):
        h = self.dropout(self.layers[0](x))
        return x + self.dropout(self.layers[1](h))


class RaCFormerDecoderLayer(nn.Module):
    def __init__(self, embed_dims=256, num_frames=8, num_points=4,
                 num_points_bev=4, num_levels=4, num_classes=10, code_size=10,
                 img_depth_num=3, bev_depth_num=5, num_ray=150,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 bev_spatial_shape=(128, 128), image_hw=(256, 704)):
        super().__init__()
        C = embed_dims
        self.num_frames, self.num_ray = num_frames, num_ray
        self.image_hw = tuple(image_hw)
        self.position_encoder = nn.Sequential(
            Linear(3, C), layer_norm(C), nn.ReLU(),
            Linear(C, C), layer_norm(C), nn.ReLU())
        self.self_attn = ScaleAdaptiveSelfAttention(C, 8, pc_range)
        self.norm1 = layer_norm(C)
        bev = dict(embed_dims=C, num_frames=num_frames, num_heads=4,
                   num_points=num_points_bev, depth_num=bev_depth_num,
                   pc_range=pc_range, spatial_shape=bev_spatial_shape)
        self.sampling_radar_bev = BEVSampling(**bev)
        self.sampling_radar_bev.temporal_encoder = RadarBEVTemporalEncoder(C)
        self.norm_radar_bev = layer_norm(C)
        self.sampling_lss_bev = BEVSampling(**bev)
        self.norm_lss_bev = layer_norm(C)
        self.sampling = ImageRadialSampling(
            C, num_frames, 4, num_points, num_levels, img_depth_num, pc_range)
        self.mixing = AdaptiveMixing(num_points * num_frames * img_depth_num,
                                     128, 4, C)
        self.norm2 = layer_norm(C)
        self.fusion = Linear(3 * C, C)
        self.norm_fusion = layer_norm(C)
        self.ffn = FFN(C, 512)
        self.norm3 = layer_norm(C)
        self.cls_branch = nn.Sequential(
            Linear(C, C), layer_norm(C), nn.ReLU(),
            Linear(C, C), layer_norm(C), nn.ReLU(), Linear(C, num_classes))
        self.reg_branch = nn.Sequential(
            Linear(C, C), nn.ReLU(), Linear(C, C), nn.ReLU(),
            Linear(C, code_size))

    def refine_bbox(self, bbox_proposal, bbox_delta):
        """Polar residual update."""
        dz = inverse_sigmoid(bbox_proposal[..., 1:3])
        dz_new = torch.sigmoid(bbox_delta[..., 1:3] + dz)
        theta = bbox_proposal[..., 0:1] + (
            torch.sigmoid(bbox_delta[..., 0:1]) * 2.0 - 1.0) / self.num_ray
        return torch.cat([theta, dz_new, bbox_delta[..., 3:]], dim=-1)

    def forward(self, query_bbox, query_feat, feat_cat, lss_value, radar_value,
                lidar2img, time_diff, d_region, attn_mask=None):
        """Returns (cls_score [B, Q, cls], polar bbox_pred [B, Q, 10],
        query_feat [B, Q, C])."""
        query_feat = query_feat + self.position_encoder(query_bbox[..., :3])
        query_feat = self.norm1(self.self_attn(query_bbox, query_feat,
                                               attn_mask))
        q_radar = self.norm_radar_bev(self.sampling_radar_bev(
            query_bbox, query_feat, radar_value, time_diff, d_region))
        q_lss = self.norm_lss_bev(self.sampling_lss_bev(
            query_bbox, query_feat, lss_value, time_diff, d_region))
        sampled = self.sampling(query_bbox, query_feat, feat_cat, lidar2img,
                                time_diff, self.image_hw, d_region)
        query_feat = self.norm2(self.mixing(sampled, query_feat))
        query_feat = self.norm_fusion(self.fusion(
            torch.cat([query_feat, q_radar, q_lss], dim=-1)))
        query_feat = self.norm3(self.ffn(query_feat))
        cls_score = self.cls_branch(query_feat)
        bbox_pred = self.refine_bbox(query_bbox, self.reg_branch(query_feat).float())
        if self.num_frames > 1:
            # absolute velocity from the first history frame's time delta
            td = torch.where(time_diff.abs() < 1e-5,
                             torch.ones_like(time_diff), time_diff)
            bbox_pred = torch.cat(
                [bbox_pred[..., :8], bbox_pred[..., 8:] / td[:, 1:2, None]],
                dim=-1)
        return cls_score.float(), bbox_pred, query_feat


class RaCFormerDecoder(nn.Module):
    def __init__(self, num_layers: int = 6,
                 d_region_list: Sequence[float] = (0.08, 0.07, 0.06, 0.05, 0.04, 0.03),
                 gather_dtype: torch.dtype = torch.bfloat16,
                 remat_policy: Optional[str] = None, **layer_cfg):
        super().__init__()
        self.num_layers = num_layers
        self.d_region_list = tuple(d_region_list)
        self.gather_dtype = gather_dtype
        self.remat = True  # checkpoint each iteration in train mode
        self.remat_policy = resolve_remat_policy(remat_policy)
        self.decoder_layer = RaCFormerDecoderLayer(**layer_cfg)

    def _iteration(self, seed, *args):
        """One decoder iteration with its dropout masks drawn from `seed`
        (None: dropout off)."""
        rng = None if seed is None else DropoutRNG(seed, args[0].device)
        with dropout_rng(rng):
            return self.decoder_layer(*args)

    def forward(self, query_bbox, query_feat, feat_cat, lss_bev, radar_bev,
                lidar2img, time_diff, attn_mask=None):
        """lss_bev / radar_bev: [B, T, H, W, C] raw BEV maps; attn_mask:
        optional [Q, Q] bool self-attention mask (True = blocked). Returns
        (cls_scores [Lyr, B, Q, cls], bbox_preds [Lyr, B, Q, 10] with
        normalized xy centers)."""
        layer = self.decoder_layer
        radar_bev = layer.sampling_radar_bev.temporal_encoder(radar_bev)
        radar_value = layer.sampling_radar_bev.project_value(
            radar_bev, self.gather_dtype)
        lss_value = layer.sampling_lss_bev.project_value(lss_bev, self.gather_dtype)
        rng = current_dropout_rng() if self.training else None
        remat = self.training and self.remat and torch.is_grad_enabled()
        cls_all, bbox_all = [], []
        for i in range(self.num_layers):
            args = (None if rng is None else rng.spawn(), query_bbox,
                    query_feat, feat_cat, lss_value, radar_value, lidar2img,
                    time_diff, self.d_region_list[i], attn_mask)
            if remat:
                context = remat_context(self.remat_policy)
                kw = {} if context is None else {"context_fn": context}
                cls_score, bbox_pred, query_feat = checkpoint(
                    self._iteration, *args, use_reentrant=False, **kw)
            else:
                cls_score, bbox_pred, query_feat = self._iteration(*args)
            cls_all.append(cls_score)
            bbox_all.append(theta_d_to_xy(bbox_pred))
            query_bbox = bbox_pred.detach()
        return torch.stack(cls_all), torch.stack(bbox_all)
