"""RaCFormer detector assembly (port of `racformer_tpu/model/racformer.py`).

ResNet-50 + FPN over all cameras of a frame, CustomFPN -> radar-assisted LSS
view transform, the radar pillar branch, and the polar-query decoder head.
`encode_frame` / `decode_window` split the network so the streaming
evaluator keeps a ring buffer of per-frame features and encodes only the
newest frame per step (both without gradients); `forward` is the offline
path that encodes every frame of the window: without gradients in eval mode,
and in train mode (`model.train()`) the training forward of the JAX
`train_mode=True` model: gradients through the trunk for all T frames, the
history frames' BEV maps detached, BatchNorm statistics over all T frames,
query denoising from the ground truth.

Dtypes follow the JAX package: the image trunk computes in `trunk_dtype`
(bf16) from f32 parameters, the image pyramid and BEV value maps the decoder
gathers from are stored in bf16 (`trunk_dtype` / `gather_dtype`), the radar
branch runs in f32 and the head in `head_dtype` (f32 by default; with bf16
its coordinate and box math stays f32 and its outputs are f32).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ..nn.decoder import CLS_PRIOR_BIAS, resolve_remat_policy
from ..nn.fpn import FPN, CustomFPN
from ..nn.head import RaCFormerHead
from ..nn.layers import BatchNorm
from ..nn.pillar_encoder import PillarFeatureNet, radar_bev_conv
from ..nn.resnet import ResNet50
from ..nn.view_transformer import LSSViewTransformer
from ..ops import device_constant
from ..ops.msmv import level_concat
from ..ops.pillars import PillarGrid
from ..utils import tracing

IMG_MEAN = (123.675, 116.280, 103.530)  # RGB
IMG_STD = (58.395, 57.120, 57.375)


def preprocess_images(imgs: torch.Tensor, bgr_to_rgb: bool = True) -> torch.Tensor:
    """Normalize raw 0-255 images [..., H, W, 3] (BGR by default) to f32."""
    x = imgs.float()
    if bgr_to_rgb:
        x = x.flip(-1)
    return (x - device_constant(IMG_MEAN, x.device)) / device_constant(
        IMG_STD, x.device)


class RaCFormer(nn.Module):
    def __init__(self, num_cams: int = 6, num_frames: int = 8,
                 embed_dims: int = 256, num_query: int = 900,
                 num_clusters: int = 6, num_levels: int = 4,
                 num_groups: int = 4, num_classes: int = 10,
                 decoder: Optional[dict[str, Any]] = None,
                 image_hw=(256, 704),
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 depth_bins: int = 96, bev_size=(128, 128),
                 num_decoder_layers: int = 6,
                 trunk_dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32,
                 query_denoising: bool = True, max_gt: int = 64,
                 bn_frame0_only: bool = False,
                 fused_gather: Optional[bool] = None):
        """Arguments as the JAX `RaCFormer`'s fields. `decoder` is the
        config file's decoder block (num_layers, d_region_list, num_points,
        ...), merged over the defaults; its `gather_dtype` sets the BEV value
        maps' storage dtype. `head_dtype`: the decoder's and head's compute
        dtype (parameters stay f32). `bn_frame0_only` (train mode only): the
        BEV branches run frame 0 in train mode and the history frames in
        eval mode without gradients, the reference's exact BatchNorm
        semantics; off, they run every frame of the window in train mode.
        `fused_gather`: None or True samples the decoder's three sites with
        the fold gather (K1) in eval mode, False with the per-point sampler
        (K2's forward), as the JAX package's unfused path; train mode always
        samples every point."""
        super().__init__()
        self.num_cams, self.num_frames = num_cams, num_frames
        self.bn_frame0_only = bn_frame0_only
        self.embed_dims, self.num_levels, self.num_groups = embed_dims, num_levels, num_groups
        self.image_hw = tuple(image_hw)
        self.bev_size = tuple(bev_size)
        self.depth_bins = depth_bins
        self.trunk_dtype, self.head_dtype = trunk_dtype, head_dtype
        # the eval decode samples through K1 (`eval.graphs` captures only
        # such a decode)
        self.folds = fused_gather is not False
        C = embed_dims
        self.img_backbone = ResNet50(dtype=trunk_dtype)
        self.img_neck = FPN((256, 512, 1024, 2048), C)
        self.img_lss_neck = CustomFPN((1024, 2048), C)
        voxel = ((pc_range[3] - pc_range[0]) / bev_size[1],
                 (pc_range[4] - pc_range[1]) / bev_size[0],
                 pc_range[5] - pc_range[2])
        self.img_lss_view_transformer = LSSViewTransformer(
            input_size=image_hw, depth_bins=depth_bins, in_channels=C,
            out_channels=C, grid_lower=tuple(pc_range[0:3]),
            grid_interval=voxel, grid_size=(bev_size[1], bev_size[0], 1),
            dtype=trunk_dtype)
        self.radar_voxel_encoder = PillarFeatureNet(PillarGrid(
            pc_range=tuple(pc_range), voxel_size=voxel, nx=bev_size[1],
            ny=bev_size[0]))
        self.radar_bev_conv = radar_bev_conv(64, C)
        decoder_cfg = dict(num_layers=num_decoder_layers, embed_dims=C,
                           num_frames=num_frames, num_levels=num_levels,
                           num_classes=num_classes, pc_range=tuple(pc_range),
                           bev_spatial_shape=tuple(bev_size),
                           image_hw=tuple(image_hw))
        decoder_cfg.update(decoder or {})
        decoder_cfg["fused_gather"] = fused_gather
        self.num_classes, self.max_gt = num_classes, max_gt
        self.pts_bbox_head = RaCFormerHead(
            num_classes, num_query, num_clusters, C, pc_range, decoder_cfg,
            query_denoising=query_denoising, max_gt=max_gt, dtype=head_dtype)

    def _trunk(self, imgs):
        """[S, N, H, W, 3] -> (level-concatenated sampler-ready pyramid
        [S, G, N, rcat, Wmax, 2c], lss_feat [S, N, H/16, W/16, C] f32).

        Level l of camera n starts at row n * rcat + roffs[l]
        (`nn.img_sampling.concat_geometry`); narrower levels are zero-padded
        on the right to the level-0 width."""
        with tracing.span("model.trunk"):
            S, N, H, W, _ = imgs.shape
            c2, c3, c4, c5 = self.img_backbone(imgs.reshape(S * N, H, W, 3))
            G = self.num_groups
            c = self.embed_dims // G
            levels = []
            for l, f in enumerate(self.img_neck([c2, c3, c4, c5])):
                h, w = f.shape[1:3]
                if (h, w) != (H // (4 << l), W // (4 << l)):
                    raise ValueError(f"level {l} is {h}x{w} for a {H}x{W} image")
                levels.append(f.reshape(S, N, h, w, G, c).permute(0, 4, 1, 2, 3, 5))
            feat_cat = level_concat(levels)
            lss_feat = self.img_lss_neck([c4, c5])
            hf, wf = lss_feat.shape[1:3]
            return feat_cat, lss_feat.float().reshape(S, N, hf, wf, self.embed_dims)

    def _bev_branches(self, lss_feat, radar_points, radar_mask, radar_depth,
                      radar_rcs, img2lidar):
        with tracing.span("model.bev"):
            S, N = lss_feat.shape[:2]
            mlp_input = img2lidar[..., :3, :3].reshape(S, N, 9)
            lss_bev, depth_logits = self.img_lss_view_transformer(
                lss_feat, radar_depth, radar_rcs, img2lidar, mlp_input)
            radar_bev = self.radar_bev_conv(
                self.radar_voxel_encoder(radar_points, radar_mask))
            return lss_bev, radar_bev, depth_logits

    def _encode(self, imgs, radar_points, radar_mask, radar_depth, radar_rcs,
                img2lidar):
        feat_cat, lss_feat = self._trunk(imgs)
        lss_bev, radar_bev, depth_logits = self._bev_branches(
            lss_feat, radar_points, radar_mask, radar_depth, radar_rcs,
            img2lidar)
        return feat_cat, lss_bev, radar_bev, depth_logits

    def _decode(self, feat_cat, lss_bev, radar_bev, lidar2img, time_diff,
                **gt):
        dt = self.head_dtype
        with tracing.span("model.head"):
            return self.pts_bbox_head(feat_cat, lss_bev.to(dt), radar_bev.to(dt),
                                      lidar2img.float(), time_diff.float(), **gt)

    @torch.no_grad()
    def encode_frame(self, imgs, radar_points, radar_mask, radar_depth,
                     radar_rcs, img2lidar):
        """One (batched) frame. imgs: [S, N, H, W, 3] normalized;
        radar_points: [S, P, 7]; radar_mask: [S, P]; radar_depth / radar_rcs:
        [S, N, H, W]; img2lidar: [S, N, 4, 4].

        Returns (feat_cat [S, G, N, rcat, Wmax, 2c], lss_bev [S, ny, nx, C],
                 radar_bev [S, ny, nx, C], depth_logits [S, N, hf, wf, D])."""
        return self._encode(imgs, radar_points, radar_mask, radar_depth,
                            radar_rcs, img2lidar)

    @torch.no_grad()
    def decode_window(self, feat_cat, lss_bev, radar_bev, lidar2img, time_diff):
        """Head over a T-frame window. feat_cat: [B, T, G, N, rcat, Wmax, 2c];
        lss_bev / radar_bev: [B, T, ny, nx, C]; lidar2img: [B, T, N, 4, 4];
        time_diff: [B, T]."""
        return self._decode(feat_cat, lss_bev, radar_bev, lidar2img, time_diff)

    def forward(self, imgs, radar_points, radar_mask, radar_depth, radar_rcs,
                lidar2img, img2lidar, time_diff, gt_bboxes=None,
                gt_labels=None, gt_mask=None, dn=None):
        """Offline forward: every frame of the window is encoded.
        imgs: [B, T, N, H, W, 3] normalized. Returns the head's outputs plus
        frame 0's 'depth_logits' [B, N, hf, wf, D].

        Eval mode runs without gradients. Train mode takes the ground truth
        (gt_bboxes [B, G, 9], gt_labels [B, G], gt_mask [B, G]) and the
        query-denoising draws `dn` (`nn.head.dn_draws`)."""
        if not self.training:
            with torch.no_grad():
                return self._window(imgs, radar_points, radar_mask,
                                    radar_depth, radar_rcs, lidar2img,
                                    img2lidar, time_diff, {})
        gt = dict(gt_bboxes=gt_bboxes, gt_labels=gt_labels, gt_mask=gt_mask,
                  dn=dn)
        return self._window(imgs, radar_points, radar_mask, radar_depth,
                            radar_rcs, lidar2img, img2lidar, time_diff, gt)

    def _window(self, imgs, radar_points, radar_mask, radar_depth, radar_rcs,
                lidar2img, img2lidar, time_diff, gt):
        B, T, N, H, W, _ = imgs.shape
        ny, nx = self.bev_size
        if self.training and self.bn_frame0_only and T > 1:
            feat_cat, lss_bev, radar_bev, depth_logits = self._encode_frame0_bn(
                imgs, radar_points, radar_mask, radar_depth, radar_rcs,
                img2lidar)
        else:
            feat_cat, lss_bev, radar_bev, depth_logits = self._encode(
                imgs.reshape(B * T, N, H, W, 3),
                radar_points.reshape(B * T, *radar_points.shape[2:]),
                radar_mask.reshape(B * T, -1),
                radar_depth.reshape(B * T, N, H, W),
                radar_rcs.reshape(B * T, N, H, W),
                img2lidar.reshape(B * T, N, 4, 4))
            lss_bev = lss_bev.reshape(B, T, ny, nx, -1)
            radar_bev = radar_bev.reshape(B, T, ny, nx, -1)
            depth_logits = depth_logits.reshape(
                B, T, *depth_logits.shape[1:])[:, 0]
            if self.training:
                # history frames give the BEV branches no gradient (the
                # reference runs them in eval mode under no_grad)
                lss_bev = torch.cat([lss_bev[:, :1], lss_bev[:, 1:].detach()],
                                    1)
                radar_bev = torch.cat(
                    [radar_bev[:, :1], radar_bev[:, 1:].detach()], 1)
        outs = self._decode(feat_cat.reshape(B, T, *feat_cat.shape[1:]),
                            lss_bev, radar_bev, lidar2img, time_diff, **gt)
        outs["depth_logits"] = depth_logits
        return outs

    def _encode_frame0_bn(self, imgs, radar_points, radar_mask, radar_depth,
                          radar_rcs, img2lidar):
        """`bn_frame0_only`: the trunk over every frame, then the BEV
        branches over frame 0 in train mode and over frames 1..T-1 in eval
        mode (running statistics, left unchanged) without gradients."""
        B, T, N, H, W, _ = imgs.shape
        feat_cat, lss_feat = self._trunk(imgs.reshape(B * T, N, H, W, 3))
        lss_feat = lss_feat.reshape(B, T, *lss_feat.shape[1:])
        inputs = (lss_feat, radar_points, radar_mask, radar_depth, radar_rcs,
                  img2lidar)
        lss0, radar0, depth_logits = self._bev_branches(
            *[a[:, 0] for a in inputs])
        branches = (self.img_lss_view_transformer, self.radar_voxel_encoder,
                    self.radar_bev_conv)
        for m in branches:
            m.eval()
        try:
            with torch.no_grad():
                lssr, radarr, _ = self._bev_branches(
                    *[a[:, 1:].reshape(B * (T - 1), *a.shape[2:])
                      for a in inputs])
        finally:
            for m in branches:
                m.train()
        ny, nx = self.bev_size
        lss_bev = torch.cat([lss0[:, None], lssr.reshape(B, T - 1, ny, nx, -1)],
                            1)
        radar_bev = torch.cat(
            [radar0[:, None], radarr.reshape(B, T - 1, ny, nx, -1)], 1)
        return feat_cat, lss_bev, radar_bev, depth_logits

CONFIG_FIELDS = ("num_cams", "num_frames", "embed_dims", "num_query",
                 "num_clusters", "num_levels", "num_groups", "num_classes",
                 "decoder", "image_hw", "pc_range", "depth_bins", "bev_size",
                 "query_denoising", "num_decoder_layers", "max_gt",
                 "trunk_dtype", "head_dtype", "bn_frame0_only", "fused_gather")
# the dtype names a config (or an --override) gives, as flax accepts them
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _dtype(field: str, value) -> torch.dtype:
    if isinstance(value, torch.dtype) and value in DTYPES.values():
        return value
    if isinstance(value, str) and value in DTYPES:
        return DTYPES[value]
    raise ValueError(f"{field}={value!r}: expected one of {sorted(DTYPES)}")


def _fused_gather(value) -> Optional[bool]:
    """None, a bool, or "true" / "false" in any case (an --override of
    `model.fused_gather=false` arrives as the string)."""
    if value is None or isinstance(value, bool):
        return value
    if isinstance(value, str) and value.lower() in ("true", "false"):
        return value.lower() == "true"
    raise ValueError(f"fused_gather={value!r}: expected None, True or False")


def config_kwargs(cfg) -> dict:
    """`RaCFormer`'s arguments from a config (a dict of the config file's
    names), as `train.py` builds the JAX model's: the `model` block's
    fields, one class per name of `class_names` unless the block names
    `num_classes`, the `decoder` block unless the model block has one.

    Every field of the JAX `RaCFormer` is taken but `train_mode` (the
    port's `model.train()`), dtypes as names (`DTYPES`) or torch dtypes,
    the decoder's `gather_dtype` likewise. An unknown field, a dtype or a
    `fused_gather` the port cannot read, or an unknown decoder
    `remat_policy` (`nn.decoder.REMAT_POLICIES`) raises a ValueError that
    names it."""
    kwargs = dict(cfg["model"])
    unknown = sorted(set(kwargs) - set(CONFIG_FIELDS))
    if unknown:
        raise ValueError(f"model fields the port cannot honour: {unknown} "
                         f"(it takes {list(CONFIG_FIELDS)})")
    for field in ("trunk_dtype", "head_dtype"):
        if field in kwargs:
            kwargs[field] = _dtype(field, kwargs[field])
    if "fused_gather" in kwargs:
        kwargs["fused_gather"] = _fused_gather(kwargs["fused_gather"])
    if "num_classes" not in kwargs and cfg.get("class_names"):
        kwargs["num_classes"] = len(cfg["class_names"])
    kwargs["decoder"] = dict(kwargs.get("decoder") or cfg.get("decoder") or {})
    if "gather_dtype" in kwargs["decoder"]:
        kwargs["decoder"]["gather_dtype"] = _dtype(
            "decoder.gather_dtype", kwargs["decoder"]["gather_dtype"])
    resolve_remat_policy(kwargs["decoder"].get("remat_policy"))
    return kwargs


@torch.no_grad()
def random_init_(model: RaCFormer, generator: torch.Generator) -> RaCFormer:
    """Seeded random weights with no zero kernels, for smoke runs.

    Every weight is drawn (LeCun-normal for convs and linears, N(0, 1) for
    embeddings, 1 + noise for norm scales); BatchNorm running statistics are
    random too. The reference zero-initializes the sampling-offset and
    mixing-generator kernels, which would make the samplers ignore the query
    features; here they get small random kernels instead. The reg branch's
    output layer is scaled down so the refined boxes stay near the ring
    initialization, which keeps the image sample points in view."""

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator).to(t.device) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            scale = 1.0
            if name.endswith(("sampling_offset", "reg_branch.4")):
                scale = 0.1
            normal(mod.weight, scale / fan_in ** 0.5)
            if mod.bias is not None:
                normal(mod.bias, 0.1)
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 1.0)
        elif isinstance(mod, nn.LayerNorm):
            normal(mod.weight, 0.1)
            mod.weight.add_(1.0)
            normal(mod.bias, 0.1)
        elif isinstance(mod, BatchNorm):
            normal(mod.weight, 0.1)
            mod.weight.add_(1.0)
            normal(mod.bias, 0.1)
            normal(mod.running_mean, 0.1)
            mod.running_var.copy_(0.5 + torch.rand(
                mod.running_var.shape, generator=generator).to(mod.running_var.device))
    sa = model.pts_bbox_head.transformer.decoder.decoder_layer.self_attn
    normal(sa.attention.attn.in_proj_weight, 1.0 / sa.attention.attn.in_proj_weight.shape[1] ** 0.5)
    normal(sa.attention.attn.in_proj_bias, 0.1)
    layer = model.pts_bbox_head.transformer.decoder.decoder_layer
    layer.cls_branch[-1].bias.fill_(CLS_PRIOR_BIAS)
    model.pts_bbox_head.reset_query_bbox(generator)
    return model
