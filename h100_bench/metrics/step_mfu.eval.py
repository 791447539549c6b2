"""The whole eval step's share of the chip's dense bf16 peak, in %: the
matmul and convolution FLOPs of one frame (one frame's encode plus one
window's decode, counted on the reference; the configuration's file keeps
the count and the command that made it) times the frames served after the
traced stretch, over their wall time."""

from h100_bench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    flops = ctx.flops.get("eval_frame")
    if not flops or not ctx.untraced:
        return None
    frames = len(ctx.untraced) * ctx.frames_per_step
    return 100.0 * flops * frames / ctx.untraced_s / PEAK_BF16_FLOPS
