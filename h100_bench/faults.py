"""Faults planted under the timed path, to see the check that
decides `correct` fail. `run.py --fault <name>` runs a cell with one (on
the card, at the cell's own size); the tests run each at a tiny size on
the CPU. Each planter takes the cell's driver and returns a function that
takes the fault out again, or None."""

from __future__ import annotations


def frozen_ring(driver):
    """The step returns its state unchanged: the window never shifts."""
    ev = driver.ev
    inner = ev._window
    ev._window = lambda new, old, reset: (old if old is not None
                                          else inner(new, old, reset))


def half_the_streams(driver):
    """Half of the batch left out: the second half of the streams is served
    from the first half's frames."""
    ev = driver.ev
    inner = ev.step_batch

    def step_batch(frames, resets, blocking=True):
        h = len(frames) // 2
        return inner(frames[:h] * 2, list(resets[:h]) * 2, blocking)

    ev.step_batch = step_batch


def _in_decode(alter):
    """Plant `alter(out, cls_scores)` on the port's decoded boxes, in place,
    where the streaming evaluator makes them; returns the undo."""
    import racformer_tpu_torch.eval.streaming as streaming

    inner = streaming.decode_boxes

    def decode_boxes(cls_scores, *a, **k):
        out = inner(cls_scores, *a, **k)
        alter(out, cls_scores)
        return out

    streaming.decode_boxes = decode_boxes
    return lambda: setattr(streaming, "decode_boxes", inner)


def moved_box(driver):
    """An answer altered where it is produced: every frame's first box moved
    by ten metres."""
    return _in_decode(lambda out, cls: out["bboxes"][:, 0, 0].add_(10.0))


def wrong_labels(driver):
    """An answer altered where it is produced: every detection under the
    next class's label (a wrong `idx % C`)."""
    def alter(out, cls):
        out["labels"].copy_((out["labels"] + 1) % cls.shape[-1])

    return _in_decode(alter)


def wrong_queries(driver):
    """An answer altered where it is produced: every detection served with
    the box of the detection ranked after it (a box from the wrong query, as
    a wrong `idx // C` picks it)."""
    def alter(out, cls):
        out["bboxes"].copy_(out["bboxes"].roll(-1, dims=1))

    return _in_decode(alter)


def frozen_weights(driver):
    """The step returns its state unchanged: AdamW never updates."""
    driver.opt.adamw.step = lambda *a, **k: None


def half_the_batch(driver):
    """Half of the batch left out, the mean taken over the rest: every
    batch's first sample in place of all."""
    inner = driver.step_fn
    driver.step_fn = lambda batch, **k: inner(
        {n: v[[0] * v.shape[0]] for n, v in batch.items()}, **k)


def scaled_gradient(driver):
    """An answer altered where it is produced: the largest leaf's gradient
    doubled before the optimizer takes it."""
    inner = driver.opt.step
    leaf = max(driver.opt.params.values(), key=lambda p: p.numel())

    def step():
        leaf.grad.mul_(2.0)
        return inner()

    driver.opt.step = step


# the faults each kind of cell can have (one chip: no exchange to leave out)
BY_KIND = {
    "stream": (frozen_ring, moved_box, wrong_labels, wrong_queries),
    "lockstep": (frozen_ring, half_the_streams, moved_box, wrong_labels, wrong_queries),
    "train": (frozen_weights, half_the_batch, scaled_gradient),
}
FAULTS = {f.__name__: f for fs in BY_KIND.values() for f in fs}
