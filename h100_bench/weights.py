"""Seeded random weights, made on the device in a few large calls.

Both sides load the same state dict under the port's reference-checkpoint
names: the program under test and the benchmark's plain reference. The
names, shapes and the kind of each leaf come from the reference's module
tree (a copy of the port's), so nothing here is read from the program.

The draws follow the port's smoke weights: LeCun-normal kernels (a tenth of
that for the sampling offsets and the last box layer, so that refined boxes
stay near the ring and the image sample points in view), N(0, 0.1) biases,
N(0, 1) embeddings, norm scales 1 + N(0, 0.1), BatchNorm running means
N(0, 0.1) and variances 0.5 + U(0, 1), the class prior on the last class
layer's bias and the ring layout in the query boxes. Leaves no rule covers
(the frustum, the code weights, BatchNorm's step counters) are constants of
the configuration: each side keeps its own.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .reference.nn.decoder import CLS_PRIOR_BIAS
from .reference.nn.head import ring_points
from .reference.nn.layers import BatchNorm

SMALL_KERNELS = ("sampling_offset", "reg_branch.4")


def leaf_rules(model: nn.Module):
    """[(name, shape, std, offset, uniform)] for every drawn leaf: the value
    is offset + std * N(0, 1), or offset + U(0, 1) where `uniform`."""
    rules = []

    def add(name, t, std, offset=0.0, uniform=False):
        rules.append((name, tuple(t.shape), std, offset, uniform))

    for mname, mod in model.named_modules():
        p = mname + "." if mname else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            scale = 0.1 if mname.endswith(SMALL_KERNELS) else 1.0
            add(p + "weight", mod.weight, scale / mod.weight[0].numel() ** 0.5)
            if mod.bias is not None:
                add(p + "bias", mod.bias, 0.1)
        elif isinstance(mod, nn.Embedding):
            add(p + "weight", mod.weight, 1.0)
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            add(p + "weight", mod.weight, 0.1, 1.0)
            add(p + "bias", mod.bias, 0.1)
            if isinstance(mod, BatchNorm):
                add(p + "running_mean", mod.running_mean, 0.1)
                add(p + "running_var", mod.running_var, 0.0, 0.5, True)
        elif isinstance(getattr(mod, "in_proj_weight", None), nn.Parameter):
            add(p + "in_proj_weight", mod.in_proj_weight,
                1.0 / mod.in_proj_weight.shape[1] ** 0.5)
            add(p + "in_proj_bias", mod.in_proj_bias, 0.1)
    return rules


def make_state_dict(model: nn.Module, seed: int, device) -> dict:
    """{name: tensor} of every drawn leaf, from `seed`, made on `device`:
    one normal and one uniform draw for all leaves together, then scaled
    and offset leaf by leaf as views of the two flat buffers."""
    rules = leaf_rules(model)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _, _ in rules]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(
        torch.tensor([r[2] for r in rules], device=device), counts)
    off = torch.repeat_interleave(
        torch.tensor([r[3] for r in rules], device=device), counts)
    uni = torch.repeat_interleave(
        torch.tensor([r[4] for r in rules], device=device), counts)
    flat = off + torch.where(uni, u, std * z)
    out, at = {}, 0
    for (name, shape, _, _, _), n in zip(rules, sizes):
        out[name] = flat[at:at + n].view(shape)
        at += n
    head = model.pts_bbox_head
    qb = out["pts_bbox_head.init_query_bbox.weight"]
    qb[:, 2] = 0.5
    qb[:, 5] = 0.2
    qb[:, 8:10] = 0.0
    qb[:, :2] = ring_points(head.num_query, head.num_clusters).to(device)
    layer = head.transformer.decoder.decoder_layer
    cls_bias = f"pts_bbox_head.transformer.decoder.decoder_layer.cls_branch.{len(layer.cls_branch) - 1}.bias"
    out[cls_bias].fill_(CLS_PRIOR_BIAS)
    return out


def load(model: nn.Module, state: dict) -> None:
    """Load `state` into `model`; every leaf it does not hold must be one
    of the configuration's constants (see the module note)."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected:
        raise KeyError(f"leaves the model lacks: {unexpected[:5]}")
    drawn = [k for k in missing if not k.endswith(
        ("num_batches_tracked", "frustum", "code_weights"))]
    if drawn:
        raise KeyError(f"leaves no rule draws: {drawn[:5]}")
