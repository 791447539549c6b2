"""Samples of all train steps completed in the window, over the window
(host clock)."""


def read(ctx):
    return len(ctx.records) * ctx.frames_per_step / ctx.window_s
