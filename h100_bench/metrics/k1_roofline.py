"""K1's share of its roofline in the traced stretch, in %: the least time of
every K1 call the stretch made (inputs, unique map columns and outputs once
at the HBM rate, `roofline.bound_ms`), taken on the inputs each call site
was given, over K1's device time (kernels named as `profiling` names K1)."""

from h100_bench.profiling import KERNEL_PATTERNS
from h100_bench.roofline import bound_ms


def prepare(ctx):
    """Record the inputs of every K1 call while the profiler runs; returns
    the function that takes the records out of the call sites again."""
    import racformer_tpu_torch.ops.deform_attn as deform_attn
    import racformer_tpu_torch.ops.msmv as msmv

    calls = ctx.k1_calls = []
    sites = {mod: mod.patch_sample_fold for mod in (msmv, deform_attn)}
    for mod, inner in sites.items():
        def spy(fused, row, x0p, wx, wy, wl, fold, _inner=inner):
            if ctx.profiling:
                calls.append((tuple(fused.shape), fused.element_size(),
                              (row, x0p, wx, wy, wl), fold))
            return _inner(fused, row, x0p, wx, wy, wl, fold)

        mod.patch_sample_fold = spy
    return lambda: [setattr(mod, "patch_sample_fold", f) for mod, f in sites.items()]


def read(ctx):
    k1_s = ctx.trace.device_s(KERNEL_PATTERNS["K1"])
    if not ctx.k1_calls or k1_s <= 0:
        return None
    least_ms = sum(bound_ms("gather_fold", shape, pts, es, fold)[0]
                   for shape, es, pts, fold in ctx.k1_calls)
    return 100.0 * least_ms / 1e3 / k1_s
