"""The host's time per train step in the program's `train.matching` spans
(the cost's copy to the host and the Jonker-Volgenant assignment), in ms,
summed over the microbatches of each step id, over the steps after the
traced stretch, from the program's span recorder (host clock). A program
without the spans gives nothing."""

from h100_bench.harness import metric_module

dispatch = metric_module("dispatch_ms.eval")
prepare = dispatch.prepare


def read(ctx):
    tracing = dispatch.recorder()
    if tracing is None or not ctx.untraced:
        return None
    recs = tracing.records()
    steps = dispatch.steps_after(recs, "train.step", ctx)
    if not steps:
        return None
    return sum(r.ms for r in recs
               if r.name == "train.matching" and r.step in steps) / len(steps)
