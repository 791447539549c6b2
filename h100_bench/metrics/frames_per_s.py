"""Frames whose boxes reached the host in the window, over the window
(host clock; a lockstep step serves one frame of each stream)."""


def read(ctx):
    return len(ctx.records) * ctx.frames_per_step / ctx.window_s
