"""Fused fold gather (kernel K1): bilinear sample + y-mix + scalar weight +
fold sum in one pass over a sampler-ready map.

Port of `racformer_tpu/ops/gather_kernel.py::patch_sample_fold` (the Pallas
kernel `_make_fold_kernel`). The CUDA kernel is `csrc/gather_fold.cu`; its
source note says what bounds it and how the design follows. This module
holds:

  * `patch_sample_fold_reference`, the plain PyTorch version (used for CPU
    tensors, by the tests, and by `chip_smoke.py` to check the kernel);
  * `patch_sample_fold`, the wrapper: CPU tensors take the plain version,
    CUDA tensors launch the kernel (built at first use) or raise;
  * `LAUNCHES`, the number of kernel launches the wrapper made;
  * `force_reference()`, a context that routes CUDA tensors to the plain
    version, for comparing the two on the card.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

LAUNCHES = 0  # kernel launches made by `patch_sample_fold`
_force_reference = False
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@contextlib.contextmanager
def force_reference():
    """Route CUDA tensors to the plain version inside the block (the kernel
    against plain comparison of `chip_smoke.py`)."""
    global _force_reference
    prev, _force_reference = _force_reference, True
    try:
        yield
    finally:
        _force_reference = prev


def patch_sample_fold_reference(fused, row, x0p, wx, wy, wl, fold):
    """Plain version of K1. fused: [S, R, Wp, 2C]; row / x0p: int [S, K]
    absolute fused-map row and bordered column of each point's top-left
    corner; wx / wy: lerp weights [S, K]; wl: scalar weights [S, K].
    Returns [S, K // fold, C] in fused.dtype (f32 arithmetic)."""
    S, R, Wp, C2 = fused.shape
    C = C2 // 2
    K = row.shape[1]
    base = torch.arange(S, device=fused.device)[:, None] * (R * Wp)
    gidx = (base + row.long() * Wp + x0p.long()).reshape(-1)
    table = fused.reshape(-1, C2)
    v0 = table.index_select(0, gidx).float()
    v1 = table.index_select(0, gidx + 1).float()
    wxf = wx.reshape(-1, 1).float()
    xl = v0 * (1.0 - wxf) + v1 * wxf
    wyf = wy.reshape(-1, 1).float()
    wlf = wl.reshape(-1, 1).float()
    out = (1.0 - wyf) * wlf * xl[:, :C] + wyf * wlf * xl[:, C:]
    return out.reshape(S, K // fold, fold, C).sum(2).to(fused.dtype)


def _library():
    from . import cuda_lib

    lib = cuda_lib.load("gather_fold", ("gather_fold.cu",))
    fn = lib.racformer_gather_fold
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ctypes.c_int64,
                       ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def build() -> None:
    """Build (or load) the CUDA library now instead of at the first launch."""
    _library()


def _check(fused, row, x0p, wx, wy, wl, fold):
    if fused.dim() != 4 or fused.shape[-1] % 4:
        raise ValueError(f"fused map must be [S, R, Wp, 2C] with C even, "
                         f"got {tuple(fused.shape)}")
    S = fused.shape[0]
    if row.dim() != 2 or row.shape[0] != S:
        raise ValueError(f"row must be [S={S}, K], got {tuple(row.shape)}")
    K = row.shape[1]
    if K == 0 or fold <= 0 or K % fold:
        raise ValueError(f"K={K} must be a positive multiple of fold={fold}")
    for name, t in (("x0p", x0p), ("wx", wx), ("wy", wy), ("wl", wl)):
        if tuple(t.shape) != (S, K):
            raise ValueError(f"{name} must be [{S}, {K}], got {tuple(t.shape)}")
    if fused.shape[2] < 2:
        raise ValueError("fused map needs at least two columns")


def patch_sample_fold(fused, row, x0p, wx, wy, wl, fold):
    """K1: see `patch_sample_fold_reference` for the contract. On CUDA the
    inputs must be contiguous, the map float32 or bfloat16, row / x0p int32
    and wx / wy / wl float32; indices must lie in the map (0 <= row < R,
    0 <= x0p <= Wp - 2), which the samplers guarantee by clamping."""
    global LAUNCHES
    _check(fused, row, x0p, wx, wy, wl, fold)
    if fused.device.type == "cpu" or _force_reference:
        return patch_sample_fold_reference(fused, row, x0p, wx, wy, wl, fold)
    if fused.device.type != "cuda":
        raise ValueError(f"unsupported device {fused.device}")
    if fused.dtype not in _DTYPE_CODES:
        raise TypeError(f"map dtype {fused.dtype} not in {list(_DTYPE_CODES)}")
    expect = ((row, torch.int32), (x0p, torch.int32), (wx, torch.float32),
              (wy, torch.float32), (wl, torch.float32))
    for t, dt in expect:
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
    for t in (fused, row, x0p, wx, wy, wl):
        if t.device != fused.device:
            raise ValueError(f"tensor on {t.device}, map on {fused.device}")
        if not t.is_contiguous():
            raise ValueError("fold gather inputs must be contiguous")
    S, R, Wp, C2 = fused.shape
    K = row.shape[1]
    out = torch.empty((S, K // fold, C2 // 2), dtype=fused.dtype,
                      device=fused.device)
    lib = _library()
    err = lib.racformer_gather_fold(
        _DTYPE_CODES[fused.dtype], fused.data_ptr(), row.data_ptr(),
        x0p.data_ptr(), wx.data_ptr(), wy.data_ptr(), wl.data_ptr(),
        out.data_ptr(), S, R * Wp * C2, Wp, C2 // 2, K, fold,
        torch.cuda.current_stream(fused.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_fold kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
