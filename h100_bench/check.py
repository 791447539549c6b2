"""The numbers that decide `correct`: what the timed path served, against
the plain reference run on the same inputs after the window.

A served frame is the step's decoded boxes: the top `max_num` (query,
class) pairs by score, each with its score, label and box. Top-k order
changes on rounding, so the served detections are matched, not taken
position by position. Each served detection is matched to the reference
query whose decoded box lies nearest its box, and is judged there as a
whole:

* box gaps: the distance of the served box to that query's box: the
  largest difference of a field (metres, sizes, velocity), the yaw taken
  round the circle.
* score gaps: the logit distance of the served score to the reference's
  logit of that query in the served label. A box served with another
  query's score, or a score under the wrong label, reads here.
* rank gaps: the distances between the served scores and the reference's
  top scores over all (query, class) pairs, each list sorted: a served set
  that is not the top of the scores reads here. The k-th largest of a set
  of values moves by no more than the largest move of a value, so each is
  at most the widest logit gap over all pairs.

Of each, the checked frames give the mean gap over all their answers, the
worst frame's mean and the widest gap (`FrameGaps`); `box_sep_min` is the
smallest distance from a served box to the second-nearest reference box,
which says whether the match could have picked another query.

Each cell's limits are in `limits/<cell>.json`, with the readings they were
set from in `PERF.md`; the numbers a cell's limits do not name are printed
as readings.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
YAW = 6  # the yaw's field in a decoded box


def load_limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double()
    return torch.log(p) - torch.log1p(-p)


def rank_gaps(served_scores, ref_cls) -> torch.Tensor:
    """[K] logit gaps of the served scores (sorted descending) against the
    reference's K best logits of ref_cls [Q, C], each list sorted."""
    s = torch.as_tensor(np.asarray(served_scores)).double()
    ref = torch.topk(ref_cls.reshape(-1).double(), s.numel()).values.cpu()
    gap = (logit(s) - ref).abs()
    return gap if bool(torch.isfinite(gap).all()) else torch.full_like(gap, math.inf)


def box_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[K, 9] x [M, 9] -> [K, M] largest field difference, yaw wrapped."""
    d = (a[:, None, :] - b[None, :, :]).abs()
    yaw = d[..., YAW] % (2 * math.pi)
    d[..., YAW] = torch.minimum(yaw, 2 * math.pi - yaw)
    return d.amax(-1)


def matched_gaps(served: dict, ref_cls, ref_boxes) -> dict:
    """Each served detection (score, label, box) against the reference
    query whose box [Q, 9] lies nearest: {"box", "score", "sep"}, each [K],
    and {"rank"} (`rank_gaps`). A detection that is not finite reads inf."""
    a = torch.as_tensor(np.asarray(served["bboxes"])).to(ref_boxes.device).double()
    s = torch.as_tensor(np.asarray(served["scores"])).double()
    labels = torch.as_tensor(np.asarray(served["labels"])).long()
    K = a.shape[0]
    rank = rank_gaps(served["scores"], ref_cls)
    if not bool(torch.isfinite(a).all()):
        inf = torch.full((K,), math.inf, dtype=torch.float64)
        return {"box": inf, "score": inf, "sep": inf, "rank": rank}
    near = box_distance(a, ref_boxes.double()).topk(2, dim=1, largest=False)
    q = near.indices[:, 0].cpu()
    C = ref_cls.shape[-1]
    ok = (labels >= 0) & (labels < C)
    ref_logit = ref_cls.double().cpu()[q, labels.clamp(0, C - 1)]
    score = torch.where(ok, (logit(s) - ref_logit).abs(),
                        torch.full((K,), math.inf, dtype=torch.float64))
    if not bool(torch.isfinite(score).all()):
        score = torch.full_like(score, math.inf)
    return {"box": near.values[:, 0].cpu(), "score": score,
            "sep": near.values[:, 1].cpu(), "rank": rank}


class FrameGaps:
    """The gaps of the checked frames, for scores, boxes and ranks: the
    mean over every served answer of every checked frame (`*_gap_mean`),
    the largest of the frames' own means (`*_gap_frame`) and the widest gap
    (`*_gap`); and `box_sep_min`."""

    KINDS = ("score", "box", "rank")

    def __init__(self):
        self.sums = dict.fromkeys(self.KINDS, 0.0)
        self.count = 0
        self.numbers = {f"{k}_gap{s}": 0.0 for k in self.KINDS
                        for s in ("_mean", "_frame", "")}
        self.numbers["box_sep_min"] = math.inf

    def add(self, gaps: dict):
        self.count += 1
        n = self.numbers
        for k in self.KINDS:
            g = gaps[k]
            self.sums[k] += float(g.mean())
            n[f"{k}_gap"] = max(n[f"{k}_gap"], float(g.max()))
            n[f"{k}_gap_frame"] = max(n[f"{k}_gap_frame"], float(g.mean()))
            n[f"{k}_gap_mean"] = self.sums[k] / self.count
        n["box_sep_min"] = min(n["box_sep_min"], float(gaps["sep"].min()))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks, readings): `checks` {name: {"value", "limit"}} of
    every number the limits name, each at or under its limit for
    `correct`; `readings` the numbers they do not name."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    ok = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks, {k: v for k, v in numbers.items() if k not in limits}
