"""Sampler-ready feature maps and the training path's bilinear sample,
frozen from the port's `ops/bilinear.py` for the benchmark's reference, its
operator under a name of its own and its gathers the plain versions (port of `racformer_tpu/ops/bilinear.py`: `PAD`, `pad_for_sampling`,
`fuse_rows`, the coordinate handling of `bilinear_sample_views_nhwc` and the
custom VJP `_patch_sample_pallas`, here the operator `patch_sample_op`).

A sampler-ready map is zero-bordered by `PAD` on both spatial axes and
y-fused: row h of the fused map holds rows h and h+1 of the bordered map in
its two channel halves, so every 2x2 bilinear patch is two adjacent columns
of one fused row. The fold gather (`ops.gather_kernel`) reads columns
`x0p` and `x0p + 1 <= W + PAD + 1`, so the stored width `W + 2 * PAD` is
enough: the JAX package's extra right padding to an 8-aligned width exists
only for the TPU kernel's aligned 16-wide windows and is not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import gather_kernel, scatter_kernel

PAD = 2  # zero border; sampling coordinates are clamped to [-PAD, W]


def pad_for_sampling(feat: torch.Tensor) -> torch.Tensor:
    """Zero-pad the two spatial axes of [..., H, W, C] by `PAD`."""
    return F.pad(feat, (0, 0, PAD, PAD, PAD, PAD))


def fuse_rows(padded: torch.Tensor) -> torch.Tensor:
    """fused[..., h, w, :] = concat(p[..., h, w, :], p[..., h+1, w, :]):
    [..., Hp, Wp, C] -> [..., Hp - 1, Wp, 2C]."""
    return torch.cat([padded[..., :-1, :, :], padded[..., 1:, :, :]], dim=-1)


def sampler_ready(feat: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> zero-bordered y-fused [..., H + 2*PAD - 1,
    W + 2*PAD, 2C]."""
    return fuse_rows(pad_for_sampling(feat))


def corner_coords(x_pix, y_pix, H, W, dtype):
    """Top-left corner and lerp weights of pixel coordinates on an (H, W)
    map: floor, clamp to [-PAD, W] / [-PAD, H] (far-outside points land in
    the zero border), shift by PAD. wx / wy are rounded to `dtype` (the map
    dtype, as the JAX per-level path rounds them) and returned as float32,
    so their gradients are rounded to `dtype` on the way back too.

    Returns (x0p, y0p) int32 and (wx, wy) float32, each x_pix's shape."""
    x0 = torch.floor(x_pix)
    y0 = torch.floor(y_pix)
    wx = (x_pix - x0).to(dtype).float()
    wy = (y_pix - y0).to(dtype).float()
    x0p = x0.clamp(-PAD, W).to(torch.int32) + PAD
    y0p = y0.clamp(-PAD, H).to(torch.int32) + PAD
    return x0p, y0p, wx, wy


SITES = ("img", "bev")  # a sample's site, for the decoder's remat policies
OP_NAME = "h100_bench_reference::patch_sample"


@torch.library.custom_op(OP_NAME, mutates_args=())
def patch_sample_op(fused: torch.Tensor, row: torch.Tensor, x0p: torch.Tensor,
                    wx: torch.Tensor, wy: torch.Tensor,
                    site: str) -> torch.Tensor:
    """Bilinear sample of a sampler-ready map, the plain versions of K2-K4
    both ways, the contract of the JAX custom VJP `_patch_sample_pallas`:
    forward K2 (`gather_kernel.patch_gather`), backward K3
    (`scatter_kernel.patch_scatter`) for the map and K4
    (`gather_kernel.patch_corner_grads`) for wx and wy. The integer inputs
    get no gradient. An operator of its own (not an autograd.Function), so
    that a selective-checkpoint policy sees it and can keep its output:
    `site` ("img" or "bev") names the sampler it serves
    (`nn.decoder.REMAT_POLICIES`)."""
    return gather_kernel.patch_gather(fused, row, x0p, wx, wy)


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])


def _patch_sample_backward(ctx, g):
    fused, row, x0p, wx, wy = ctx.saved_tensors
    g = g.to(fused.dtype).contiguous()
    d_fused = d_wx = d_wy = None
    if ctx.needs_input_grad[0]:
        d_fused = scatter_kernel.patch_scatter(
            g, row, x0p, wx, wy, fused.shape)  # in the map dtype
    if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
        d_wx, d_wy = gather_kernel.patch_corner_grads(
            fused, g, row, x0p, wx, wy)
    return d_fused, None, None, d_wx, d_wy, None


patch_sample_op.register_autograd(_patch_sample_backward,
                                  setup_context=_save_inputs)


def patch_sample(fused, row, x0p, wx, wy, site="img"):
    """fused [S, R, Wp, 2C]; row / x0p int [S, K]; wx / wy float [S, K]
    (see `ops.gather_kernel` for the contract). Returns [S, K, C] in the map
    dtype, differentiable in fused, wx and wy."""
    if site not in SITES:
        raise ValueError(f"site {site!r} not in {SITES}")
    c = lambda t, dt: t.to(dt).contiguous()
    return patch_sample_op(fused.contiguous(), c(row, torch.int32),
                           c(x0p, torch.int32), c(wx, torch.float32),
                           c(wy, torch.float32), site)
