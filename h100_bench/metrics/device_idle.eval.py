"""The share of the time in which no kernel ran on the device, in %: the
device's busy time per step in the traced stretch (the union of its kernel
intervals) against the wall time per step of the steps after it. The
profiler slows the host about twofold, so its own stretch's wall time would
overstate the idle share; the device's busy time it does not move."""


def read(ctx):
    if ctx.trace.busy_s <= 0 or not ctx.untraced:
        return None
    busy = ctx.trace.busy_s / ctx.trace.units
    wall = ctx.untraced_s / len(ctx.untraced)
    return 100.0 * (1.0 - busy / wall)
