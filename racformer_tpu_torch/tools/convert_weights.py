"""JAX -> port weight conversion: the inverse of
`racformer_tpu/tools/convert_weights.py::convert_state_dict`.

`state_dict_from_jax` walks the port's own state-dict keys (which are the
reference checkpoint's), finds each key's flax path with the JAX package's
rule table, and inverts the layout transform: HWIO -> OIHW for convs,
[in, out] -> [out, in] for linears and 1x1 convs stored as Dense, BN
scale / bias from `params` and mean / var from `batch_stats`. The three flax
`q_proj` / `k_proj` / `v_proj` are joined back into `in_proj_*`. Entries the
flax tree does not hold (the frustum and code_weights buffers, which come
from the config, and BN step counters) keep the port model's own values.
`grads_from_jax` carries a gradient tree (which has the params' structure)
across the same way, for the parameters only.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from racformer_tpu.tools import convert_weights as cw

_IN_PROJ = re.compile(
    rf"{cw._H}\.transformer\.decoder\.decoder_layer\.self_attn\."
    rf"attention\.attn\.in_proj_(weight|bias)$")


def _rule(key: str):
    for prefix, fn in (("img_backbone.", cw._resnet_rules),
                       ("img_neck.", lambda s: cw._fpn_rules(s, "img_neck")),
                       ("img_lss_neck.", lambda s: cw._fpn_rules(s, "img_lss_neck"))):
        if key.startswith(prefix):
            return fn(key[len(prefix):])
    return cw._detector_rules(key)


def _leaf(tree: Dict, path: str) -> np.ndarray:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node)


def _invert(fn, value: np.ndarray, shape) -> np.ndarray:
    if fn is cw._conv:  # HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if fn is cw._linear:
        return value.T
    if fn is cw._dense_or_conv1x1:  # Dense [in, out] -> [out, in] (+ 1x1)
        return value.T.reshape(shape)
    return value


def state_dict_from_jax(variables_np: Dict, model: torch.nn.Module,
                        keys=None) -> Dict:
    """variables_np: the JAX model's {'params': ..., 'batch_stats': ...} as
    numpy trees; model: the port model whose keys and shapes to fill; keys:
    the state-dict keys to convert (default: all).
    Returns a state dict for `model.load_state_dict`. Raises KeyError for a
    port key with no flax counterpart."""
    out = {}
    for key, ref in model.state_dict().items():
        if keys is not None and key not in keys:
            continue
        if any(p.search(key) for p in cw.IGNORED_KEYS):
            out[key] = ref.detach().clone()
            continue
        m = _IN_PROJ.match(key)
        if m:
            leaf = "kernel" if m.group(1) == "weight" else "bias"
            parts = [_leaf(variables_np, f"params/{cw._LP}/self_attn/{n}/{leaf}")
                     for n in ("q_proj", "k_proj", "v_proj")]
            value = np.concatenate(
                [p.T if leaf == "kernel" else p for p in parts], axis=0)
        else:
            rule = _rule(key)
            if rule is None:
                raise KeyError(f"no flax path for port key {key}")
            path, fn = rule
            value = _invert(fn, _leaf(variables_np, path), tuple(ref.shape))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax value {value.shape} vs port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(ref.dtype)
    return out


def grads_from_jax(grads_np: Dict, model: torch.nn.Module) -> Dict:
    """grads_np: a numpy tree with the JAX params' structure (e.g. the
    gradients of a train step). Returns {parameter name: tensor} in the port
    model's layout."""
    names = {n for n, _ in model.named_parameters()}
    return state_dict_from_jax({"params": grads_np}, model, keys=names)
