"""The host's dispatch time per served frame, in ms: from the start of the
program's `eval.step` span to the start of the `eval.result` span of the
same step id (the blocking copy of the boxes, whose wait is the device's),
over the steps after the traced stretch, from the program's span recorder
(host clock). The profiler's own slowdown of the host stays out, but not
its after-effect: those steps run slower than an untraced run's (PERF.md
§3). A program without the spans gives nothing."""


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from racformer_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def prepare(ctx):
    """Record the program's spans from the warm-up on; returns the function
    that stops the recorder (its records are kept for `read`)."""
    tracing = recorder()
    if tracing is None:
        return None
    tracing.clear()
    tracing.enable()
    return tracing.disable


def steps_after(records, root, ctx):
    """{step id: root span} of the spans named `root` that opened in the
    steps after the traced stretch."""
    lo, hi = ctx.untraced[0][0] * 1e9, ctx.untraced[-1][1] * 1e9
    return {r.step: r for r in records
            if r.name == root and lo <= r.start_ns <= hi}


def read(ctx):
    tracing = recorder()
    if tracing is None or not ctx.untraced:
        return None
    recs = tracing.records()
    steps = steps_after(recs, "eval.step", ctx)
    ns = frames = 0
    for r in recs:
        if r.name == "eval.result" and r.step in steps:
            root = steps[r.step]
            ns += r.start_ns - root.start_ns
            frames += root.counts["frames"]
    return ns / 1e6 / frames if frames else None
