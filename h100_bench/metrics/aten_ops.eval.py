"""`aten::` events the profiler records per frame in the traced stretch:
the host's dispatch work (nested ops each count)."""


def read(ctx):
    return ctx.trace.aten_ops() / (ctx.trace.units * ctx.frames_per_step)
