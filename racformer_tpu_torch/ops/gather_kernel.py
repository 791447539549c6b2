"""The samplers' gather kernels over a sampler-ready map (port of
`racformer_tpu/ops/gather_kernel.py`):

  * K1, the fused fold gather `patch_sample_fold` (Pallas `_make_fold_kernel`,
    CUDA `csrc/gather_fold.cu`): bilinear sample + y-mix + scalar weight +
    fold sum, the eval path;
  * K2, the patch gather `patch_gather` (Pallas `_kernel`, CUDA
    `csrc/patch_gather.cu`): the per-point bilinear sample, the forward of the
    training path's `ops.bilinear.patch_sample_op`;
  * K4, the corner re-gather `patch_corner_grads` (Pallas `_kernel_corners`
    plus the XLA reduction after it, CUDA `csrc/patch_corner_grads.cu`): the
    location gradients d_wx, d_wy of `patch_sample_op`.

K3, the map gradient of `patch_sample_op`, is in `ops.scatter_kernel`. Each
kernel's source note says what bounds it and how the design follows. Every
kernel has a plain PyTorch version here (`*_reference`), used for CPU
tensors, by the tests, and by `chip_smoke.py` to check the kernel. The
wrappers take the plain version for CPU tensors and launch the kernel (built
at first use) for CUDA tensors, or raise; `force_reference()` routes CUDA
tensors of all four kernels to the plain versions. The launch counts are
`LAUNCHES` (K1), `GATHER_LAUNCHES` (K2), `CORNER_LAUNCHES` (K4) and
`scatter_kernel.LAUNCHES` (K3).

Point contract shared by K2-K4: `fused` [S, R, Wp, 2C] is a per-slab
zero-bordered y-fused map; `row` / `x0p` int [S, K] are each point's fused-map
row (sub-slab offsets folded in) and bordered column of its top-left corner;
`wx` / `wy` [S, K] its lerp weights.
"""

from __future__ import annotations

import contextlib

import torch

LAUNCHES = 0  # kernel launches made by `patch_sample_fold` (K1)
GATHER_LAUNCHES = 0  # kernel launches made by `patch_gather` (K2)
CORNER_LAUNCHES = 0  # kernel launches made by `patch_corner_grads` (K4)
_force_reference = False
# the map dtypes K1-K4 take, by the code their C entry points dispatch on
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@contextlib.contextmanager
def force_reference():
    """Route CUDA tensors of K1-K4 and of the matching kernel
    (`train.matching.hungarian_assign`) to their plain versions inside the
    block (the kernel against plain comparisons of `chip_smoke.py`)."""
    global _force_reference
    prev, _force_reference = _force_reference, True
    try:
        yield
    finally:
        _force_reference = prev


def use_reference(t: torch.Tensor) -> bool:
    """Whether a wrapper given `t` takes the plain version: for CPU tensors
    and inside `force_reference()`. Other devices than CPU and CUDA raise."""
    if t.device.type == "cpu" or _force_reference:
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def check_cuda_inputs(name, tensors, dtypes):
    """Raise unless every tensor has its dtype, lies on the first one's
    device and is contiguous (what the CUDA kernels take)."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, map on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def dtype_code(name, dtype):
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: map dtype {dtype} not in {list(_DTYPE_CODES)}")
    return _DTYPE_CODES[dtype]


def check_points(name, shape, row, x0p, wx, wy):
    """Shapes of the K2-K4 point contract for a map of `shape`."""
    if len(shape) != 4 or shape[-1] % 4:
        raise ValueError(f"{name}: map must be [S, R, Wp, 2C] with C even, "
                         f"got {tuple(shape)}")
    if shape[2] < 2:
        raise ValueError(f"{name}: map needs at least two columns")
    S = shape[0]
    if row.dim() != 2 or row.shape[0] != S or row.shape[1] == 0:
        raise ValueError(f"{name}: row must be [S={S}, K>0], got {tuple(row.shape)}")
    for n, t in (("x0p", x0p), ("wx", wx), ("wy", wy)):
        if t.shape != row.shape:
            raise ValueError(f"{name}: {n} must be {tuple(row.shape)}, got "
                             f"{tuple(t.shape)}")


def check_vector_loads(name, fused, *more):
    """Raise unless K1, K2 or K4 can read `fused` (and the [S, K, C] tensors
    `more`) 16 bytes per lane: C a multiple of the channels in 16 bytes (8
    in bf16 and f16, 4 in f32) and every pointer 16-byte aligned (see
    `csrc/point_tiles.cuh`; outputs come from the caching allocator, which
    aligns them)."""
    vec = 16 // fused.element_size()
    C = fused.shape[-1] // 2
    if C % vec:
        raise ValueError(f"{name}: C={C} must be a multiple of {vec} for a "
                         f"{fused.dtype} map (16-byte loads)")
    for t in (fused, *more):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor at {t.data_ptr():#x} is not "
                             f"16-byte aligned (16-byte loads)")


def current_stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name, *args):
    """Call kernel library `name`'s entry point; raise on a launch error."""
    from . import cuda_lib

    err = cuda_lib.function(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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


def fold_output(fused, row, fold):
    """An uninitialized tensor of K1's output shape, [S, K // fold, C] in
    the map dtype."""
    S, _, _, C2 = fused.shape
    return torch.empty((S, row.shape[1] // fold, C2 // 2), dtype=fused.dtype,
                       device=fused.device)


def patch_sample_fold(fused, row, x0p, wx, wy, wl, fold):
    """K1: see `patch_sample_fold_reference` for the contract. On CUDA the
    inputs must be contiguous, the map float32, bfloat16 or float16 at a
    16-byte aligned address with C a multiple of 8 (bf16, f16) or 4 (f32),
    row / x0p int32 and wx / wy / wl float32; indices must lie in the map
    (0 <= row < R, 0 <= x0p <= Wp - 2), which the samplers guarantee by
    clamping."""
    global LAUNCHES
    check_points("gather_fold", fused.shape, row, x0p, wx, wy)
    K = row.shape[1]
    if fold <= 0 or K % fold:
        raise ValueError(f"K={K} must be a positive multiple of fold={fold}")
    if wl.shape != row.shape:
        raise ValueError(f"wl must be {tuple(row.shape)}, got {tuple(wl.shape)}")
    if use_reference(fused):
        return patch_sample_fold_reference(fused, row, x0p, wx, wy, wl, fold)
    f32, i32 = torch.float32, torch.int32
    code = dtype_code("gather_fold", fused.dtype)
    check_cuda_inputs("gather_fold", (fused, row, x0p, wx, wy, wl),
                      (fused.dtype, i32, i32, f32, f32, f32))
    S, R, Wp, C2 = fused.shape
    check_vector_loads("gather_fold", fused)
    out = fold_output(fused, row, fold)
    launch("gather_fold", code, fused.data_ptr(), row.data_ptr(),
           x0p.data_ptr(), wx.data_ptr(), wy.data_ptr(), wl.data_ptr(),
           out.data_ptr(), S, R * Wp * C2, Wp, C2 // 2, K, fold,
           current_stream(fused))
    LAUNCHES += 1
    return out


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


def patch_gather(fused, row, x0p, wx, wy):
    """K2: see `patch_gather_reference`. On CUDA the inputs must be
    contiguous, the map float32, bfloat16 or float16 at a 16-byte aligned
    address with C a multiple of 8 (bf16, f16) or 4 (f32), row / x0p int32
    and wx / wy float32, with 0 <= row < R and 0 <= x0p <= Wp - 2."""
    global GATHER_LAUNCHES
    check_points("patch_gather", fused.shape, row, x0p, wx, wy)
    if use_reference(fused):
        return patch_gather_reference(fused, row, x0p, wx, wy)
    f32, i32 = torch.float32, torch.int32
    code = dtype_code("patch_gather", fused.dtype)
    check_cuda_inputs("patch_gather", (fused, row, x0p, wx, wy),
                      (fused.dtype, i32, i32, f32, f32))
    check_vector_loads("patch_gather", fused)
    S, R, Wp, C2 = fused.shape
    K = row.shape[1]
    out = torch.empty((S, K, C2 // 2), dtype=fused.dtype, device=fused.device)
    launch("patch_gather", code, fused.data_ptr(), row.data_ptr(),
           x0p.data_ptr(), wx.data_ptr(), wy.data_ptr(), out.data_ptr(), S,
           R * Wp * C2, Wp, C2 // 2, K, current_stream(fused))
    GATHER_LAUNCHES += 1
    return out


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


def patch_corner_grads(fused, g, row, x0p, wx, wy):
    """K4: see `patch_corner_grads_reference`. On CUDA g has the map's
    dtype, is contiguous and 16-byte aligned, and the other inputs are as
    for `patch_gather`."""
    global CORNER_LAUNCHES
    check_points("patch_corner_grads", fused.shape, row, x0p, wx, wy)
    S, R, Wp, C2 = fused.shape
    K = row.shape[1]
    if tuple(g.shape) != (S, K, C2 // 2):
        raise ValueError(f"patch_corner_grads: g must be {(S, K, C2 // 2)}, "
                         f"got {tuple(g.shape)}")
    if use_reference(fused):
        return patch_corner_grads_reference(fused, g, row, x0p, wx, wy)
    f32, i32 = torch.float32, torch.int32
    code = dtype_code("patch_corner_grads", fused.dtype)
    check_cuda_inputs("patch_corner_grads", (fused, g, row, x0p, wx, wy),
                      (fused.dtype, fused.dtype, i32, i32, f32, f32))
    check_vector_loads("patch_corner_grads", fused, g)
    d_wx = torch.empty((S, K), dtype=f32, device=fused.device)
    d_wy = torch.empty((S, K), dtype=f32, device=fused.device)
    launch("patch_corner_grads", code, fused.data_ptr(), g.data_ptr(),
           row.data_ptr(), x0p.data_ptr(), wx.data_ptr(), wy.data_ptr(),
           d_wx.data_ptr(), d_wy.data_ptr(), S, R * Wp * C2, Wp, C2 // 2, K,
           current_stream(fused))
    CORNER_LAUNCHES += 1
    return d_wx, d_wy
