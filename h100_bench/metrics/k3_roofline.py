"""K3's share of its roofline in the traced train steps, in %: the least
time of every K3 call the stretch made (the cotangent, the points and the
whole map gradient once at the HBM rate, `roofline.bound_ms`), taken on the
inputs each call was given, over K3's device time (its bucketing and
accumulation kernels, named as `profiling` names K3)."""

from h100_bench.profiling import KERNEL_PATTERNS
from h100_bench.roofline import bound_ms


def prepare(ctx):
    """Record the inputs of every K3 call while the profiler runs; returns
    the function that takes the record out of the call site again."""
    import racformer_tpu_torch.ops.scatter_kernel as scatter_kernel

    calls = ctx.k3_calls = []
    inner = scatter_kernel.patch_scatter

    def spy(g, row, x0p, wx, wy, map_shape):
        if ctx.profiling:
            calls.append((tuple(map_shape), g.element_size(), (row, x0p, wx, wy)))
        return inner(g, row, x0p, wx, wy, map_shape)

    scatter_kernel.patch_scatter = spy
    return lambda: setattr(scatter_kernel, "patch_scatter", inner)


def read(ctx):
    k3_s = ctx.trace.device_s(KERNEL_PATTERNS["K3"])
    if not ctx.k3_calls or k3_s <= 0:
        return None
    least_ms = sum(bound_ms("patch_scatter", shape, pts, es)[0]
                   for shape, es, pts in ctx.k3_calls)
    return 100.0 * least_ms / 1e3 / k3_s
