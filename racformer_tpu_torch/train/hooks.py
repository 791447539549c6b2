"""Training hooks (a copy of `DepthWeightCurriculum` of
`racformer_tpu/train/hooks.py`; EMA and the match statistics are not ported
yet).

`DepthWeightCurriculum` matches the reference's `SequentialControlHook`: at
epoch >= start_epoch the depth loss weight drops from 2.0 to 1.0.
"""

from __future__ import annotations


class DepthWeightCurriculum:
    def __init__(self, start_epoch: int = 18, before: float = 2.0, after: float = 1.0):
        self.start_epoch = start_epoch
        self.before = before
        self.after = after

    def weight(self, epoch: int) -> float:
        return self.after if epoch >= self.start_epoch else self.before
