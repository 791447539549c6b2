"""The whole train step's share of the chip's dense bf16 peak, in %: the
matmul and convolution FLOPs of one step (the forward and backward of its
microbatches without the decoder's recompute, counted on the reference; the
configuration's file keeps the count and the command that made it) times
the steps after the traced stretch, over their wall time."""

from h100_bench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    flops = ctx.flops.get("train_step")
    if not flops or not ctx.untraced:
        return None
    return 100.0 * flops * len(ctx.untraced) / ctx.untraced_s / PEAK_BF16_FLOPS
