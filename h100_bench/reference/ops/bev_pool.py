"""LSS view transform as a segment sum into the BEV grid (port of
`racformer_tpu/ops/bev_pool.py`).

Every frustum point is kept (static shapes); points outside the grid get
weight zero and a dummy segment. The splat is `index_add_` per camera, which
bounds the depth x feature product to one camera at a time.
"""

from __future__ import annotations

import torch


def make_frustum(input_size, downsample: int, bin_values: torch.Tensor):
    """Frustum template [D, Hf, Wf, 3] of (x_pix, y_pix, depth) in
    input-image pixel coordinates."""
    H_in, W_in = input_size
    Hf, Wf = H_in // downsample, W_in // downsample
    D = bin_values.shape[0]
    dev = bin_values.device
    xs = torch.linspace(0.0, W_in - 1, Wf, device=dev)
    ys = torch.linspace(0.0, H_in - 1, Hf, device=dev)
    x = xs[None, None, :].expand(D, Hf, Wf)
    y = ys[None, :, None].expand(D, Hf, Wf)
    d = bin_values[:, None, None].expand(D, Hf, Wf)
    return torch.stack([x, y, d], dim=-1)


def frustum_grid(frustum, img2lidar, grid_lower, grid_interval, grid_size):
    """Project the frustum [D, Hf, Wf, 3] through img2lidar [N, 4, 4] and
    quantize to voxels.

    Returns (rank [N, D, Hf, Wf] int64, flattened (z * ny + y) * nx + x with
    the dummy rank nx*ny*nz for invalid points; valid [N, D, Hf, Wf]).
    Voxel coordinates truncate toward zero (the reference's `.long()`) and
    the bounds check runs on the truncated values, so coordinates in (-1, 0)
    are kept, as in the reference."""
    eps = 1e-5
    nx, ny, nz = grid_size
    d = frustum[..., 2:3].clamp(min=eps)
    uvd1 = torch.cat([frustum[..., 0:2] * d, frustum[..., 2:3],
                      torch.ones_like(d)], dim=-1)
    xyz = torch.einsum("nij,dhwj->ndhwi", img2lidar[:, :3, :], uvd1)
    lo = torch.tensor(grid_lower, dtype=xyz.dtype, device=xyz.device)
    step = torch.tensor(grid_interval, dtype=xyz.dtype, device=xyz.device)
    ci = ((xyz - lo) / step).to(torch.int64)
    valid = ((ci[..., 0] >= 0) & (ci[..., 0] < nx)
             & (ci[..., 1] >= 0) & (ci[..., 1] < ny)
             & (ci[..., 2] >= 0) & (ci[..., 2] < nz))
    rank = (ci[..., 2] * ny + ci[..., 1]) * nx + ci[..., 0]
    rank = torch.where(valid, rank, torch.full_like(rank, nx * ny * nz))
    return rank, valid


def bev_pool(depth, feat, rank, valid, grid_size):
    """depth: [N, D, Hf, Wf] depth distribution; feat: [N, Hf, Wf, C]
    context; rank / valid from :func:`frustum_grid`.

    Returns [ny, nx, nz * C] in feat.dtype (z folded into channels)."""
    nx, ny, nz = grid_size
    C = feat.shape[-1]
    out = torch.zeros((nx * ny * nz + 1, C), dtype=feat.dtype,
                      device=feat.device)
    for n in range(depth.shape[0]):
        w = torch.where(valid[n], depth[n], torch.zeros_like(depth[n]))
        prod = w[..., None] * feat[n][None]  # [D, Hf, Wf, C]
        out.index_add_(0, rank[n].reshape(-1), prod.reshape(-1, C))
    out = out[:-1].reshape(nz, ny, nx, C)
    return torch.cat([out[z] for z in range(nz)], dim=-1)
