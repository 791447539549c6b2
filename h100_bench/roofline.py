"""The chip's peaks and the least time of a hand kernel's call.

`unique_columns` and `bound_ms` are copies of `chip_smoke.py`'s (a test holds
them equal): each input byte read once (a map column counted once however
many points read it), each output byte written once, against the operations
over the float32 rate.
"""

from __future__ import annotations

from .reference.ops.gather_kernel import flat_index

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores (the samplers' arithmetic)

HBM_BYTES_PER_MS = HBM_BYTES_PER_S / 1e3
F32_OPS_PER_MS = F32_FLOPS / 1e3
# f32 operations per point and channel (of C), from the plain versions'
# arithmetic: x-lerp of both halves 6, y-mix 3; K1 adds the scalar weight and
# the fold sum; K3 2 y-products, 4 x-products, 4 adds; K4 8 per location
# gradient
OPS_PER_POINT_CHANNEL = {"gather_fold": 11, "patch_gather": 9,
                         "patch_scatter": 10, "patch_corner_grads": 16}


def unique_columns(shape, row, x0p):
    """Distinct (slab, row, column) map columns that the points read: the
    columns x0p and x0p + 1 of each point's fused row."""
    import torch

    idx = flat_index(shape, row, x0p)
    return torch.unique(torch.cat([idx, idx + 1])).numel()


def bound_ms(kernel, shape, pts, es, fold=1, reread=False):
    """(least ms, 'bytes' or 'operations') of one call of `kernel` on a map
    of `shape` and points `pts` (row, x0p, wx, wy[, wl]), elements of `es`
    bytes: each input byte read once (map columns counted once however many
    points read them, as these inputs need), each output byte written once,
    against the operations over the f32 rate. With `reread`, each point's
    two columns count as read from device memory (no reuse in L2)."""
    S, R, Wp, C2 = shape
    C = C2 // 2
    n = pts[0].numel()
    per_point = 4 * len(pts)  # int32 / f32 per-point inputs
    cols = lambda: (2 * n if reread else unique_columns(shape, pts[0], pts[1])
                    ) * C2 * es
    nbytes = {
        "gather_fold": lambda: cols() + n * per_point + n // fold * C * es,
        "patch_gather": lambda: cols() + n * per_point + n * C * es,
        "patch_scatter": lambda: n * C * es + n * per_point + S * R * Wp * C2 * es,
        "patch_corner_grads": lambda: cols() + n * C * es + n * per_point + n * 8,
    }[kernel]()
    t_b = nbytes / HBM_BYTES_PER_MS
    t_o = n * C * OPS_PER_POINT_CHANNEL[kernel] / F32_OPS_PER_MS
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
