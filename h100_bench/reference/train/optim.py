"""Optimizer and learning-rate schedule of the training recipe (port of
`racformer_tpu/train/optim.py`): AdamW, lr 4e-4, weight decay 0.01 on every
parameter, gradients clipped to a global L2 norm of 35, cosine decay to
1e-3 * lr after a 500-step linear warmup from lr / 3; 0.1x lr for the image
backbone and every `sampling_offset`; the backbone's stem and `layer1`
frozen (`frozen_stages=1`).

The clip norm is taken over ALL gradients, the frozen parameters' included,
as `optax.clip_by_global_norm` sees them before `multi_transform` zeroes the
frozen updates. The frozen parameters therefore keep `requires_grad` (their
gradients are computed) and are left out of the optimizer only.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def cosine_warmup_lr(step: int, base_lr: float = 4e-4,
                     total_steps: int = 100_000, warmup_steps: int = 500,
                     warmup_ratio: float = 1.0 / 3.0,
                     min_lr_ratio: float = 1e-3) -> float:
    """optax `join_schedules([linear warmup, cosine_decay], [warmup])` at
    `step` (the 0-based count of updates made before this one)."""
    if step < warmup_steps:
        frac = step / warmup_steps
        return base_lr * (warmup_ratio + (1.0 - warmup_ratio) * frac)
    decay_steps = max(total_steps - warmup_steps, 1)
    t = min(step - warmup_steps, decay_steps) / decay_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * t))
    return base_lr * ((1.0 - min_lr_ratio) * cosine + min_lr_ratio)


def param_label(name: str) -> str:
    """'frozen', 'backbone', 'offset' or 'normal' for a parameter name (the
    reference checkpoint's keys): stem (`conv1`, `bn1`) and `layer1` of the
    image backbone are frozen, the rest of it and every `sampling_offset`
    take 0.1x lr."""
    if name.startswith("img_backbone."):
        sub = name[len("img_backbone."):]
        if sub.startswith(("conv1.", "bn1.", "layer1.")):
            return "frozen"
        return "backbone"
    if "sampling_offset" in name:
        return "offset"
    return "normal"


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all gradients (f32)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


class Optimizer:
    """AdamW with the recipe's parameter groups, schedule and clipping.

    `step()` clips the gradients of ALL parameters (frozen ones included)
    to the global norm `clip_norm`, sets each group's lr from the schedule
    at the number of updates made so far, and updates every parameter but
    the frozen ones. Returns the gradient norm before clipping."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 base_lr: float = 4e-4, weight_decay: float = 0.01,
                 total_steps: int = 100_000, warmup_steps: int = 500,
                 clip_norm: float = 35.0):
        self.params = dict(named_params)
        self.labels = {n: param_label(n) for n in self.params}
        self.base_lr, self.total_steps = base_lr, total_steps
        self.warmup_steps, self.clip_norm = warmup_steps, clip_norm
        self.mult = {"normal": 1.0, "backbone": 0.1, "offset": 0.1}
        groups = [{"params": [p for n, p in self.params.items()
                              if self.labels[n] == label],
                   "label": label, "lr": base_lr * m}
                  for label, m in self.mult.items()]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=base_lr, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=weight_decay)
        self.count = 0

    def lr(self, label: str = "normal", step: int | None = None) -> float:
        return cosine_warmup_lr(self.count if step is None else step,
                                self.base_lr * self.mult[label],
                                self.total_steps, self.warmup_steps)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params.values() if p.grad is not None]
        norm = global_norm(grads)
        # optax: g if norm < clip else g / norm * clip
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(group["label"])
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        """AdamW's state (moments, step counts, groups) and the number of
        updates made, which sets the schedule's position."""
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def frozen(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.params.items()
                if self.labels[n] == "frozen"}
