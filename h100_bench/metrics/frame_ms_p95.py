"""95th percentile over all frames of the window of the time from handing a
frame to `step` until its decoded boxes are numpy arrays on the host."""

from h100_bench.harness import p95


def read(ctx):
    return p95([(t1 - t0) * 1e3 for t0, t1 in ctx.records])
