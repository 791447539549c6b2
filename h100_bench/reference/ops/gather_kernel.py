"""The samplers' gathers over a sampler-ready map, frozen from the port's
`ops/gather_kernel.py` for the benchmark's reference: the plain versions of
K1 (`patch_sample_fold`), K2 (`patch_gather`) and K4 (`patch_corner_grads`)
only, with no kernel behind them.

Point contract shared by K2-K4: `fused` [S, R, Wp, 2C] is a per-slab
zero-bordered y-fused map; `row` / `x0p` int [S, K] are each point's fused-map
row (sub-slab offsets folded in) and bordered column of its top-left corner;
`wx` / `wy` [S, K] its lerp weights.
"""

from __future__ import annotations

import torch


def flat_index(shape, row, x0p):
    """Row index of each point's top-left corner in the map viewed as
    [S * R * Wp, 2C] (the top-right corner is the next row)."""
    S, R, Wp, _ = shape
    base = torch.arange(S, device=row.device)[:, None] * (R * Wp)
    return (base + row.long() * Wp + x0p.long()).reshape(-1)


def _corners(fused, row, x0p):
    """f32 columns x0p and x0p + 1 of every point, [S*K, 2C] each."""
    idx = flat_index(fused.shape, row, x0p)
    table = fused.reshape(-1, fused.shape[-1])
    return (table.index_select(0, idx).float(),
            table.index_select(0, idx + 1).float())


# --- K1: fused fold gather ----------------------------------------------


def patch_sample_fold_reference(fused, row, x0p, wx, wy, wl, fold):
    """Plain version of K1. fused: [S, R, Wp, 2C]; row / x0p: int [S, K]
    absolute fused-map row and bordered column of each point's top-left
    corner; wx / wy: lerp weights [S, K]; wl: scalar weights [S, K].
    Returns [S, K // fold, C] in fused.dtype (f32 arithmetic)."""
    S, R, Wp, C2 = fused.shape
    C = C2 // 2
    K = row.shape[1]
    v0, v1 = _corners(fused, row, x0p)
    wxf = wx.reshape(-1, 1).float()
    xl = v0 * (1.0 - wxf) + v1 * wxf
    wyf = wy.reshape(-1, 1).float()
    wlf = wl.reshape(-1, 1).float()
    out = (1.0 - wyf) * wlf * xl[:, :C] + wyf * wlf * xl[:, C:]
    return out.reshape(S, K // fold, fold, C).sum(2).to(fused.dtype)


# --- K2: patch gather ----------------------------------------------------


def patch_gather_reference(fused, row, x0p, wx, wy):
    """Plain version of K2: the bilinear sample of every point,
    (1 - wy) * xl[:C] + wy * xl[C:] with xl the x-lerp of its two columns.
    Returns [S, K, C] in fused.dtype (f32 arithmetic)."""
    S, K = row.shape
    C = fused.shape[-1] // 2
    v0, v1 = _corners(fused, row, x0p)
    wxf = wx.reshape(-1, 1).float()
    wyf = wy.reshape(-1, 1).float()
    xl = v0 * (1.0 - wxf) + v1 * wxf
    out = xl[:, :C] * (1.0 - wyf) + xl[:, C:] * wyf
    return out.reshape(S, K, C).to(fused.dtype)


# --- K4: corner re-gather with the location gradients -------------------


def patch_corner_grads_reference(fused, g, row, x0p, wx, wy):
    """Plain version of K4: the gradients of `patch_gather`'s output with
    cotangent g [S, K, C] with respect to wx and wy, from the four corners
    (f32 arithmetic). Returns (d_wx, d_wy), each [S, K] float32."""
    S, K = row.shape
    C = fused.shape[-1] // 2
    v0, v1 = _corners(fused, row, x0p)
    v00, v10, v01, v11 = v0[:, :C], v0[:, C:], v1[:, :C], v1[:, C:]
    g32 = g.reshape(-1, C).float()
    wxf = wx.reshape(-1, 1).float()
    wyf = wy.reshape(-1, 1).float()
    d_wx = (g32 * ((v01 - v00) * (1 - wyf) + (v11 - v10) * wyf)).sum(-1)
    top = v00 * (1 - wxf) + v01 * wxf
    bot = v10 * (1 - wxf) + v11 * wxf
    d_wy = (g32 * (bot - top)).sum(-1)
    return d_wx.reshape(S, K), d_wy.reshape(S, K)



def patch_sample_fold(fused, row, x0p, wx, wy, wl, fold):
    return patch_sample_fold_reference(fused, row, x0p, wx, wy, wl, fold)


def patch_gather(fused, row, x0p, wx, wy):
    return patch_gather_reference(fused, row, x0p, wx, wy)


def patch_corner_grads(fused, g, row, x0p, wx, wy):
    return patch_corner_grads_reference(fused, g, row, x0p, wx, wy)
