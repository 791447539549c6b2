"""The device time per served frame of the kernels launched under the
program's `eval.decode_window` span in the traced stretch, in ms, read as
`encode_ms.eval` reads its span's."""

from h100_bench.harness import metric_module

SPAN = "racformer.eval.decode_window"


def read(ctx):
    ms = metric_module("encode_ms.eval").span_device_ms(ctx.trace, SPAN)
    return None if ms is None else ms / (ctx.trace.units * ctx.frames_per_step)
