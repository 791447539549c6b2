"""The patch scatter-add (the plain version of kernel K3), frozen from
the port's `ops/scatter_kernel.py` for the benchmark's reference: the map
gradient of the training samplers' bilinear sample, summed by `index_add_`
in float32.
"""

from __future__ import annotations

import torch

from . import gather_kernel as gk


def _fused_cotangent(g, wy):
    """[S*K, 2C] f32: the cotangent split over the two fused rows,
    g * (1 - wy) | g * wy, rounded to bf16 as the JAX backward's kernel
    operand is, whatever g's dtype (float16 too)."""
    C = g.shape[-1]
    g32 = g.reshape(-1, C).float()
    wyf = wy.reshape(-1, 1).float()
    gf = torch.cat([g32 * (1.0 - wyf), g32 * wyf], dim=-1)
    return gf.to(torch.bfloat16).float()


def patch_scatter_reference(g, row, x0p, wx, wy, map_shape):
    """Plain version of K3: the gradient of `gather_kernel.patch_gather`'s
    output with cotangent g [S, K, C] with respect to its map of shape
    `map_shape` [S, R, Wp, 2C]. Sums in float32 and returns the result in
    g's dtype (the map's)."""
    gf = _fused_cotangent(g, wy)
    wxf = wx.reshape(-1, 1).float()
    idx = gk.flat_index(map_shape, row, x0p)
    acc = torch.zeros((map_shape[0] * map_shape[1] * map_shape[2],
                       map_shape[3]), dtype=torch.float32, device=g.device)
    acc.index_add_(0, idx, gf * (1.0 - wxf))
    acc.index_add_(0, idx + 1, gf * wxf)
    return acc.reshape(map_shape).to(g.dtype)


def patch_scatter(g, row, x0p, wx, wy, map_shape):
    return patch_scatter_reference(g, row, x0p, wx, wy, map_shape)
