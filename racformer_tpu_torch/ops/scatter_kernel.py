"""The patch scatter-add (kernel K3): the map gradient of the training
samplers' bilinear sample (port of `racformer_tpu/ops/scatter_kernel.py`,
the Pallas `_kernel` that `bilinear._patch_sample_bwd_impl` calls).

The CUDA kernel is `csrc/patch_scatter.cu`; its source note says what bounds
it and how the design follows: the points are bucketed by destination row,
cut into tiles of about 1,024 points (a hot row into several), and each
tile's block accumulates its rows in shared memory and writes each once in
the map dtype. This module holds the plain PyTorch versions
`patch_scatter_reference` (`index_add_` in f32) and `bucket_by_row_reference`
(the bucketing contract the kernel relies on), the wrappers `patch_scatter`
and `bucket_by_row` (CPU tensors take the plain version, CUDA tensors launch
the kernel or raise; `gather_kernel.force_reference()` routes CUDA tensors
to the plain version too) and `LAUNCHES`, the number of `patch_scatter` calls
that launched the kernel. The point contract is `ops.gather_kernel`'s.
"""

from __future__ import annotations

import torch

from . import gather_kernel as gk

LAUNCHES = 0  # `patch_scatter` calls that launched K3 (one per call)
_MAX_SHARED = 232_448  # dynamic shared memory a Hopper block can use
# the bucketing keeps a histogram of R rows for each of 8 warps in a block's
# shared memory, and walks the points in chunks of 1024
_MAX_ROWS = _MAX_SHARED // (8 * 4)
_CHUNK = 1024
_SPAN = 1024  # points per tile of the accumulation: the kernel's kSpan


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


def bucket_by_row_reference(row, R):
    """Plain version of K3's bucketing: the points of row [S, K] sorted by
    their key s * R + row. Returns (offsets [S*R + 1], perm [S*K]), int32:
    bucket b holds the flat point indices perm[offsets[b]:offsets[b + 1]]
    in ascending order, as the kernel lists them."""
    S = row.shape[0]
    key = (torch.arange(S, device=row.device)[:, None] * R + row.long()).reshape(-1)
    counts = torch.bincount(key, minlength=S * R)
    offsets = torch.zeros(S * R + 1, dtype=torch.int64, device=row.device)
    offsets[1:] = torch.cumsum(counts, 0)
    perm = torch.argsort(key, stable=True)
    return offsets.to(torch.int32), perm.to(torch.int32)


def _check_rows(name, row, R):
    if R > _MAX_ROWS:
        raise ValueError(f"{name}: R={R} rows exceed the bucketing's "
                         f"{_MAX_ROWS}")
    if row.numel() >= 2**31:
        raise ValueError(f"{name}: S * K must fit in int32")


def _bucket_scratch(row, R):
    """counts [S, ceil(K / 1024), R], offsets [S*R + 1] and records
    [S*K, 4], int32."""
    S, K = row.shape
    dev = row.device
    counts = torch.empty(S * -(-K // _CHUNK) * R, dtype=torch.int32, device=dev)
    offsets = torch.empty(S * R + 1, dtype=torch.int32, device=dev)
    records = torch.empty(S * K, 4, dtype=torch.int32, device=dev)
    return counts, offsets, records


def bucket_by_row(row, x0p, wx, wy, R):
    """K3's bucketing step alone (its first kernel), for checks. Returns
    (offsets [S*R + 1], records [S*K, 4]) int32: records[:, 0] is the
    permutation of `bucket_by_row_reference` (buckets in ascending point
    order), records[:, 1] holds each listed point's x0p + (row << 16) (x0p
    below 2^16), records[:, 2:] the bits of its wx, wy. On the CPU, the
    plain version's records. Does not count in `LAUNCHES`."""
    if gk.use_reference(row):
        offsets, perm = bucket_by_row_reference(row, R)
        p = perm.long()
        xr = x0p.reshape(-1)[p] + (row.reshape(-1)[p] << 16)
        records = torch.stack([perm, xr.to(torch.int32),
                               wx.float().reshape(-1)[p].view(torch.int32),
                               wy.float().reshape(-1)[p].view(torch.int32)], 1)
        return offsets, records
    i32, f32 = torch.int32, torch.float32
    gk.check_cuda_inputs("bucket_by_row", (row, x0p, wx, wy), (i32, i32, f32, f32))
    _check_rows("bucket_by_row", row, R)
    counts, offsets, records = _bucket_scratch(row, R)
    gk.launch("bucket_rows", row.data_ptr(), x0p.data_ptr(), wx.data_ptr(),
              wy.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
              records.data_ptr(), row.shape[0], R, row.shape[1],
              gk.current_stream(row))
    return offsets, records


def patch_scatter(g, row, x0p, wx, wy, map_shape):
    """K3: see `patch_scatter_reference`. On CUDA g is float32, bfloat16 or
    float16 (its terms rounded to bf16 before the f32 sums whatever its
    dtype, as in the plain version), row / x0p int32, wx / wy float32, all
    contiguous, with 0 <= row < R and 0 <= x0p <= Wp - 2; the result has
    g's dtype."""
    global LAUNCHES
    map_shape = tuple(map_shape)
    gk.check_points("patch_scatter", map_shape, row, x0p, wx, wy)
    S, R, Wp, C2 = map_shape
    K = row.shape[1]
    if tuple(g.shape) != (S, K, C2 // 2):
        raise ValueError(f"patch_scatter: g must be {(S, K, C2 // 2)}, got "
                         f"{tuple(g.shape)}")
    if gk.use_reference(g):
        return patch_scatter_reference(g, row, x0p, wx, wy, map_shape)
    f32, i32 = torch.float32, torch.int32
    code = gk.dtype_code("patch_scatter", g.dtype)
    gk.check_cuda_inputs("patch_scatter", (g, row, x0p, wx, wy),
                         (g.dtype, i32, i32, f32, f32))
    _check_rows("patch_scatter", row, R)
    C = C2 // 2
    if C not in (16, 32, 64, 128, 256, 512):  # whole warps of pair owners
        raise ValueError(f"patch_scatter: C={C} is not 16, 32, 64, 128, 256 "
                         f"or 512")
    if Wp * C2 * 4 + 22 * 1024 > _MAX_SHARED:  # the row and the staged windows
        raise ValueError(f"patch_scatter: a map row of {Wp} x {C2} f32 does "
                         f"not fit in a block's shared memory")
    counts, offsets, records = _bucket_scratch(row, R)
    # one f32 row per tile for the pieces of hot rows (no zero fill needed)
    slots = torch.empty(-(-S * K // _SPAN), Wp * C2, dtype=f32, device=g.device)
    out = torch.empty(map_shape, dtype=g.dtype, device=g.device)
    gk.launch("patch_scatter", code, g.data_ptr(), row.data_ptr(),
              x0p.data_ptr(), wx.data_ptr(), wy.data_ptr(), counts.data_ptr(),
              offsets.data_ptr(), records.data_ptr(), slots.data_ptr(),
              out.data_ptr(), S, R, Wp, C, K, gk.current_stream(g))
    LAUNCHES += 1
    return out
