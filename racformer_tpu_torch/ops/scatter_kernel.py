"""The patch scatter-add (kernel K3): the map gradient of the training
samplers' bilinear sample (port of `racformer_tpu/ops/scatter_kernel.py`,
the Pallas `_kernel` that `bilinear._patch_sample_bwd_impl` calls).

The CUDA kernel is `csrc/patch_scatter.cu`; its source note says what bounds
it and how the design follows. This module holds the plain PyTorch version
`patch_scatter_reference` (`index_add_` in f32), the wrapper `patch_scatter`
(CPU tensors take the plain version, CUDA tensors launch the kernel or
raise; `gather_kernel.force_reference()` routes CUDA tensors to the plain
version too) and `LAUNCHES`, the number of kernel launches. The point
contract is `ops.gather_kernel`'s.
"""

from __future__ import annotations

import torch

from . import gather_kernel as gk

LAUNCHES = 0  # kernel launches made by `patch_scatter` (K3)


def _fused_cotangent(g, wy):
    """[S*K, 2C] f32: the cotangent split over the two fused rows,
    g * (1 - wy) | g * wy, rounded to bf16 as the JAX backward's kernel
    operand is."""
    C = g.shape[-1]
    g32 = g.reshape(-1, C).float()
    wyf = wy.reshape(-1, 1).float()
    gf = torch.cat([g32 * (1.0 - wyf), g32 * wyf], dim=-1)
    return gf.to(torch.bfloat16).float()


def patch_scatter_reference(g, row, x0p, wx, wy, map_shape):
    """Plain version of K3: the gradient of `gather_kernel.patch_gather`'s
    output with cotangent g [S, K, C] with respect to its map of shape
    `map_shape` [S, R, Wp, 2C]. Returns it in float32."""
    gf = _fused_cotangent(g, wy)
    wxf = wx.reshape(-1, 1).float()
    idx = gk.flat_index(map_shape, row, x0p)
    acc = torch.zeros((map_shape[0] * map_shape[1] * map_shape[2],
                       map_shape[3]), dtype=torch.float32, device=g.device)
    acc.index_add_(0, idx, gf * (1.0 - wxf))
    acc.index_add_(0, idx + 1, gf * wxf)
    return acc.reshape(map_shape)


def patch_scatter(g, row, x0p, wx, wy, map_shape):
    """K3: see `patch_scatter_reference`. On CUDA g is float32 or bfloat16,
    row / x0p int32, wx / wy float32, all contiguous, with 0 <= row < R and
    0 <= x0p <= Wp - 2."""
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
    acc = torch.zeros(map_shape, dtype=f32, device=g.device)
    gk.launch("patch_scatter", code, g.data_ptr(), row.data_ptr(),
              x0p.data_ptr(), wx.data_ptr(), wy.data_ptr(), acc.data_ptr(), S,
              R * Wp * C2, Wp, C2 // 2, K, gk.current_stream(g))
    LAUNCHES += 1
    return acc
