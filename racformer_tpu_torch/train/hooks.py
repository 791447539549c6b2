"""Training hooks (port of `racformer_tpu/train/hooks.py`): the depth-loss
curriculum, the EMA of the weights and the match-statistics dump.

`DepthWeightCurriculum` matches the reference's `SequentialControlHook`: at
epoch >= start_epoch the depth loss weight drops from 2.0 to 1.0.

`ema_update` matches `MEGVIIEMAHook` / `ModelEMA`: decay 0.999 with a
warm-up ramp `decay * (1 - exp(-step / 2000))`, over the parameters only
(not the BatchNorm statistics), as the JAX EMA covers `state.params`.

`MatchStatsHook` is a copy of the JAX package's (numpy only): per decoder
layer it dumps the epoch's Hungarian match statistics to
`<path>/dec_{i}/rank_{r}/match_epoch{e}.json` and resets.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np
import torch


class DepthWeightCurriculum:
    def __init__(self, start_epoch: int = 18, before: float = 2.0, after: float = 1.0):
        self.start_epoch = start_epoch
        self.before = before
        self.after = after

    def weight(self, epoch: int) -> float:
        return self.after if epoch >= self.start_epoch else self.before


def ema_init(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """f32 clones of the model's parameters: clones, never aliases, since
    the optimizer updates the parameters in place."""
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               step, decay: float = 0.999) -> None:
    """ema <- ema * d + params * (1 - d), d = decay * (1 - exp(-step /
    2000)), in place over the names of `ema`."""
    d = decay * (1.0 - math.exp(-float(step) / 2000.0))
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, [params[n].detach().float() for n in names],
                        alpha=1.0 - d)


class MatchStatsHook:
    """Accumulate per-layer Hungarian match diagnostics; dump per epoch.

    Feed it the HOST copies of each step's metrics plus the step's
    ground-truth labels/mask; call `after_epoch(e)` at every epoch boundary.
    Output layout: `dec_{layer}/rank_{rank}/match_epoch{e}.json`, one JSON
    object per epoch mapping step -> {"matched_q", "cost", "label"} lists
    (invalid/padded GT slots dropped), reset after each dump.
    """

    def __init__(self, path: str, rank: int = 0, sample_every: int = 1):
        self.path = path
        self.rank = rank
        # memory bound: each recorded step keeps ~L*B*G*(4+4)+B*G*5 bytes of
        # compact numpy (roughly 50 KB at flagship scale); raise sample_every
        # to subsample long epochs
        self.sample_every = max(1, int(sample_every))
        self._steps = {}  # step -> (matched_q [L,B,G], cost [L,B,G], labels [B,G], mask [B,G])

    def record(self, step: int, metrics, gt_labels, gt_mask):
        if "_matched_q" not in metrics or int(step) % self.sample_every:
            return
        self._steps[int(step)] = (
            np.asarray(metrics["_matched_q"], dtype=np.int32),
            np.asarray(metrics["_match_cost"], dtype=np.float32),
            np.asarray(gt_labels),
            np.asarray(gt_mask).astype(bool),
        )

    def after_epoch(self, epoch: int):
        if not self._steps:
            return
        num_layers = next(iter(self._steps.values()))[0].shape[0]
        for layer in range(num_layers):
            out = {}
            for step, (mq, cost, labels, mask) in sorted(self._steps.items()):
                per_sample = []
                for b in range(mq.shape[1]):
                    m = mask[b]
                    per_sample.append({
                        "matched_q": mq[layer, b][m].tolist(),
                        "cost": [round(float(c), 4) for c in cost[layer, b][m]],
                        "label": labels[b][m].tolist(),
                    })
                out[str(step)] = per_sample
            d = os.path.join(self.path, f"dec_{layer}", f"rank_{self.rank}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"match_epoch{epoch}.json"), "w") as f:
                json.dump(out, f)
        self._steps.clear()
