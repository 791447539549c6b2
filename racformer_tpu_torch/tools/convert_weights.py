"""JAX -> port weight conversion: the inverse of
`racformer_tpu/tools/convert_weights.py::convert_state_dict`.

`state_dict_from_jax` walks the port's own state-dict keys (which are the
reference checkpoint's), finds each key's flax path with the rule tables
below, and inverts the layout transform: HWIO -> OIHW for convs,
[in, out] -> [out, in] for linears and 1x1 convs stored as Dense, BN
scale / bias from `params` and mean / var from `batch_stats`. The three flax
`q_proj` / `k_proj` / `v_proj` are joined back into `in_proj_*`. Entries the
flax tree does not hold (the frustum and code_weights buffers, which come
from the config, and BN step counters) keep the port model's own values.
`grads_from_jax` carries a gradient tree (which has the params' structure)
across the same way, for the parameters only.

`load_pretrained` merges a pretrained checkpoint (a `.pth` / `.pt` state
dict or a pickle of numpy arrays, in the reference's names, which are the
port's) into a model, after `apply_revise_keys`' prefix remap: the
train driver's `load_from`.

The rule tables are a copy of the JAX package's (the port imports nothing
of it); `tests/test_torch_config.py` holds them equal on every key of the
flagship port model. Each rule names its forward transform (`_conv`,
`_linear`, `_dense_or_conv1x1` or `np.asarray`, as the JAX package names
them); this module only inverts them.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict

import numpy as np
import torch

# reads an orbax work_dir, or a pickle whose leaves are JAX arrays, with the
# JAX package and writes a checkpoint the port reads
CONVERTER = "scripts/jax_checkpoint_to_torch.py"


class NumpyOnlyUnpickler(pickle.Unpickler):
    """Refuses a pickle whose objects come from JAX (the port imports
    none of it)."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "flax", "orbax"):
            raise SystemExit(f"the file holds {module}.{name} objects: reading "
                             f"it needs JAX; convert it with {CONVERTER}")
        return super().find_class(module, name)


def apply_revise_keys(state_dict: Dict, revise_keys) -> Dict:
    """Remap key prefixes, e.g. ('backbone', 'img_backbone') (a copy of the
    JAX package's)."""
    out = {}
    for k, v in state_dict.items():
        for old, new in revise_keys or []:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


def _conv(w):  # OIHW -> HWIO
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _linear(w):  # [out, in] -> [in, out]
    return np.transpose(np.asarray(w), (1, 0))


def _dense_or_conv1x1(val):
    """torch Linear [out, in] or 1x1 Conv [out, in, 1, 1] -> Dense [in, out]."""
    val = np.asarray(val)
    if val.ndim == 4:
        val = val[:, :, 0, 0]
    return np.transpose(val, (1, 0))


_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}
_BN_LEAVES = "(weight|bias|running_mean|running_var)"


def _resnet_rules(src: str):
    """mmdet ResNet names under `img_backbone.` -> (flax path, transform)."""
    if src == "conv1.weight":
        return "params/img_backbone/conv1/kernel", _conv
    m = re.match(rf"bn1\.{_BN_LEAVES}$", src)
    if m:
        kind = _BN[m.group(1)]
        return f"{kind[0]}/img_backbone/bn1/{kind[1]}", np.asarray
    m = re.match(r"layer(\d)\.(\d+)\.(conv\d)\.weight$", src)
    if m:
        s, i, c = m.groups()
        return f"params/img_backbone/layer{s}_{i}/{c}/kernel", _conv
    m = re.match(rf"layer(\d)\.(\d+)\.(bn\d)\.{_BN_LEAVES}$", src)
    if m:
        s, i, b, k = m.groups()
        kind = _BN[k]
        return f"{kind[0]}/img_backbone/layer{s}_{i}/{b}/{kind[1]}", np.asarray
    m = re.match(r"layer(\d)\.(\d+)\.downsample\.0\.weight$", src)
    if m:
        s, i = m.groups()
        return f"params/img_backbone/layer{s}_{i}/downsample_conv/kernel", _conv
    m = re.match(rf"layer(\d)\.(\d+)\.downsample\.1\.{_BN_LEAVES}$", src)
    if m:
        s, i, k = m.groups()
        kind = _BN[k]
        return (f"{kind[0]}/img_backbone/layer{s}_{i}/downsample_bn/{kind[1]}",
                np.asarray)
    return None


def _fpn_rules(src: str, dst_mod: str):
    m = re.match(r"(lateral|fpn)_convs\.(\d+)\.conv\.(weight|bias)$", src)
    if m is None:
        return None
    kind, i, k = m.groups()
    leaf, fn = ("kernel", _conv) if k == "weight" else ("bias", np.asarray)
    if kind == "lateral":
        name = f"lateral{i}"
    else:
        name = "fpn_out" if dst_mod == "img_lss_neck" else f"fpn{i}"
    return f"params/{dst_mod}/{name}/{leaf}", fn


# Detector rule table: (regex on the torch key, flax path template, forward
# transform); `{bn0}` / `{bn1}` in a template take the BN leaf's collection
# and name from the regex's first group.
_DETECTOR_RULES = []


def _rule(pattern, template, fn=np.asarray):
    _DETECTOR_RULES.append((re.compile(pattern), template, fn))


def _convbn(src_prefix, dst_prefix):
    """ConvModule (conv + bn) -> ConvBN {conv, norm}."""
    _rule(rf"{src_prefix}\.conv\.weight$", f"params/{dst_prefix}/conv/kernel", _conv)
    _rule(rf"{src_prefix}\.conv\.bias$", f"params/{dst_prefix}/conv/bias")
    _rule(rf"{src_prefix}\.bn\.{_BN_LEAVES}$", f"{{bn0}}/{dst_prefix}/norm/{{bn1}}")


# --- LSS view transformer / DepthNet
_VT = "img_lss_view_transformer"
_DN = f"{_VT}.depth_net"
_DNP = f"{_VT}/depth_net"
_rule(rf"{_DN}\.reduce_conv\.0\.weight$", f"params/{_DNP}/reduce_conv/conv/kernel", _conv)
_rule(rf"{_DN}\.reduce_conv\.0\.bias$", f"params/{_DNP}/reduce_conv/conv/bias")
_rule(rf"{_DN}\.reduce_conv\.1\.{_BN_LEAVES}$", f"{{bn0}}/{_DNP}/reduce_conv/norm/{{bn1}}")
_rule(rf"{_DN}\.context_conv\.(weight)$", f"params/{_DNP}/context_conv/kernel", _conv)
_rule(rf"{_DN}\.context_conv\.(bias)$", f"params/{_DNP}/context_conv/bias")
_rule(rf"{_DN}\.bn\.{_BN_LEAVES}$", f"{{bn0}}/{_DNP}/mlp_bn/{{bn1}}")
for mlp in ("depth_mlp", "context_mlp"):
    for fc in ("fc1", "fc2"):
        _rule(rf"{_DN}\.{mlp}\.{fc}\.weight$", f"params/{_DNP}/{mlp}/{fc}/kernel", _linear)
        _rule(rf"{_DN}\.{mlp}\.{fc}\.bias$", f"params/{_DNP}/{mlp}/{fc}/bias")
for se in ("depth_se", "context_se"):
    for cv in ("conv_reduce", "conv_expand"):
        _rule(rf"{_DN}\.{se}\.{cv}\.weight$", f"params/{_DNP}/{se}/{cv}/kernel",
              _dense_or_conv1x1)
        _rule(rf"{_DN}\.{se}\.{cv}\.bias$", f"params/{_DNP}/{se}/{cv}/bias")
_rule(rf"{_DN}\.dep_proj\.weight$", f"params/{_DNP}/dep_proj/kernel", _conv)
_rule(rf"{_DN}\.dep_proj\.bias$", f"params/{_DNP}/dep_proj/bias")
for i, blk in enumerate(("block1", "block2", "block3")):
    for cj, (c, b) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        _rule(rf"{_DN}\.depth_conv\.{i}\.{c}\.weight$",
              f"params/{_DNP}/{blk}/conv{cj + 1}/conv/kernel", _conv)
        _rule(rf"{_DN}\.depth_conv\.{i}\.{b}\.{_BN_LEAVES}$",
              f"{{bn0}}/{_DNP}/{blk}/conv{cj + 1}/norm/{{bn1}}")
for j in range(1, 5):
    _rule(rf"{_DN}\.depth_conv\.3\.aspp{j}\.atrous_conv\.weight$",
          f"params/{_DNP}/aspp/aspp{j}/conv/kernel", _conv)
    _rule(rf"{_DN}\.depth_conv\.3\.aspp{j}\.bn\.{_BN_LEAVES}$",
          f"{{bn0}}/{_DNP}/aspp/aspp{j}/norm/{{bn1}}")
_rule(rf"{_DN}\.depth_conv\.3\.global_avg_pool\.1\.weight$",
      f"params/{_DNP}/aspp/gap_conv/conv/kernel", _conv)
_rule(rf"{_DN}\.depth_conv\.3\.global_avg_pool\.2\.{_BN_LEAVES}$",
      f"{{bn0}}/{_DNP}/aspp/gap_conv/norm/{{bn1}}")
_rule(rf"{_DN}\.depth_conv\.3\.conv1\.weight$", f"params/{_DNP}/aspp/project/conv/kernel", _conv)
_rule(rf"{_DN}\.depth_conv\.3\.bn1\.{_BN_LEAVES}$",
      f"{{bn0}}/{_DNP}/aspp/project/norm/{{bn1}}")
_rule(rf"{_DN}\.depth_conv\.4\.weight$", f"params/{_DNP}/depth_out/kernel", _conv)
_rule(rf"{_DN}\.depth_conv\.4\.bias$", f"params/{_DNP}/depth_out/bias")
_rule(rf"{_VT}\.rcs_embedding\.weight$", f"params/{_VT}/rcs_embedding/kernel",
      _dense_or_conv1x1)
_rule(rf"{_VT}\.rcs_embedding\.bias$", f"params/{_VT}/rcs_embedding/bias")

# --- radar pillar branch
_rule(r"radar_voxel_encoder\.pfn_layers\.0\.linear\.weight$",
      "params/radar_encoder/pfn_linear/kernel", _linear)
_rule(rf"radar_voxel_encoder\.pfn_layers\.0\.norm\.{_BN_LEAVES}$",
      "{bn0}/radar_encoder/pfn_bn/{bn1}")
for i in range(3):
    _convbn(rf"radar_bev_conv\.{i}", f"radar_encoder/conv{i + 1}")

# --- head
_H = "pts_bbox_head"
_rule(rf"{_H}\.init_query_bbox\.weight$", f"params/{_H}/init_query_bbox")
_rule(rf"{_H}\.label_enc\.weight$", f"params/{_H}/label_enc/embedding")

# --- the shared decoder layer
_L = rf"{_H}\.transformer\.decoder\.decoder_layer"
_LP = f"{_H}/decoder/layer"
for src, dst in (("0", "fc1"), ("1", "ln1"), ("3", "fc2"), ("4", "ln2")):
    kind, fn = ("kernel", _linear) if dst.startswith("fc") else ("scale", np.asarray)
    _rule(rf"{_L}\.position_encoder\.{src}\.weight$",
          f"params/{_LP}/position_encoder/{dst}/{kind}", fn)
    _rule(rf"{_L}\.position_encoder\.{src}\.bias$",
          f"params/{_LP}/position_encoder/{dst}/bias")
_rule(rf"{_L}\.self_attn\.gen_tau\.weight$", f"params/{_LP}/self_attn/gen_tau/kernel", _linear)
_rule(rf"{_L}\.self_attn\.gen_tau\.bias$", f"params/{_LP}/self_attn/gen_tau/bias")
_rule(rf"{_L}\.self_attn\.attention\.attn\.out_proj\.weight$",
      f"params/{_LP}/self_attn/out_proj/kernel", _linear)
_rule(rf"{_L}\.self_attn\.attention\.attn\.out_proj\.bias$",
      f"params/{_LP}/self_attn/out_proj/bias")
for br in ("sampling", "sampling_radar_bev", "sampling_lss_bev"):
    for lin in ("sampling_offset", "ray_points_offset", "scale_weights"):
        _rule(rf"{_L}\.{br}\.{lin}\.weight$", f"params/{_LP}/{br}/{lin}/kernel", _linear)
        _rule(rf"{_L}\.{br}\.{lin}\.bias$", f"params/{_LP}/{br}/{lin}/bias")
    for lin in ("output_proj", "bev_queue_weight"):
        _rule(rf"{_L}\.{br}\.attention\.{lin}\.weight$",
              f"params/{_LP}/{br}/attention/{lin}/kernel", _linear)
        _rule(rf"{_L}\.{br}\.attention\.{lin}\.bias$",
              f"params/{_LP}/{br}/attention/{lin}/bias")
    # the value projections are hoisted out of the weight-shared layer
    _rule(rf"{_L}\.{br}\.attention\.value_proj\.weight$",
          f"params/{_H}/decoder/{br}_value/value_proj/kernel", _linear)
    _rule(rf"{_L}\.{br}\.attention\.value_proj\.bias$",
          f"params/{_H}/decoder/{br}_value/value_proj/bias")
    for emb in ("row_embed", "col_embed"):
        _rule(rf"{_L}\.{br}\.positional_encoding\.{emb}\.weight$",
              f"params/{_H}/decoder/{br}_value/positional_encoding/{emb}/embedding")
# radar temporal encoder (hoisted)
_TE = rf"{_L}\.sampling_radar_bev\.temporal_encoder"
_TEP = f"{_H}/decoder/sampling_radar_bev_temporal_encoder"
for src, dst in (("downsample", "downsample"), (r"upsample\.1", "up_conv"),
                 ("temporal_fusion", "temporal_fusion"),
                 (r"convGRU\.convGRUCell\.gates_conv", "gru/cell/gates"),
                 (r"convGRU\.convGRUCell\.matching_layer", "gru/cell/matching")):
    _rule(rf"{_TE}\.{src}\.weight$", f"params/{_TEP}/{dst}/kernel", _conv)
    _rule(rf"{_TE}\.{src}\.bias$", f"params/{_TEP}/{dst}/bias")
# mixing / fusion / ffn / norms / branches
for src, dst in (("mixing.parameter_generator", "mixing/parameter_generator"),
                 ("mixing.out_proj", "mixing/out_proj"), ("fusion", "fusion"),
                 ("ffn.layers.0.0", "ffn/fc1"), ("ffn.layers.1", "ffn/fc2")):
    src = re.escape(src)
    _rule(rf"{_L}\.{src}\.weight$", f"params/{_LP}/{dst}/kernel", _linear)
    _rule(rf"{_L}\.{src}\.bias$", f"params/{_LP}/{dst}/bias")
for nm in ("norm1", "norm2", "norm3", "norm_radar_bev", "norm_lss_bev", "norm_fusion"):
    _rule(rf"{_L}\.{nm}\.weight$", f"params/{_LP}/{nm}/scale")
    _rule(rf"{_L}\.{nm}\.bias$", f"params/{_LP}/{nm}/bias")
for src, dst in (("0", "fc0"), ("1", "ln0"), ("3", "fc1"), ("4", "ln1"), ("6", "out")):
    kind, fn = ("scale", np.asarray) if dst.startswith("ln") else ("kernel", _linear)
    _rule(rf"{_L}\.cls_branch\.{src}\.weight$", f"params/{_LP}/cls_branch/{dst}/{kind}", fn)
    _rule(rf"{_L}\.cls_branch\.{src}\.bias$", f"params/{_LP}/cls_branch/{dst}/bias")
for src, dst in (("0", "fc0"), ("2", "fc1"), ("4", "out")):
    _rule(rf"{_L}\.reg_branch\.{src}\.weight$", f"params/{_LP}/reg_branch/{dst}/kernel", _linear)
    _rule(rf"{_L}\.reg_branch\.{src}\.bias$", f"params/{_LP}/reg_branch/{dst}/bias")


def _detector_rules(key: str):
    for pat, template, fn in _DETECTOR_RULES:
        m = pat.match(key)
        if m:
            if "{bn0}" in template:
                bn0, bn1 = _BN[m.group(1)]
                return template.format(bn0=bn0, bn1=bn1), fn
            return template, fn
    return None


# state-dict entries with no flax counterpart by design: recomputed from the
# config (frustum, code_weights) or bookkeeping (BN step counters)
IGNORED_KEYS = (
    re.compile(r"\.num_batches_tracked$"),
    re.compile(r"^img_lss_view_transformer\.frustum$"),
    re.compile(r"^pts_bbox_head\.code_weights$"),
)

_IN_PROJ = re.compile(
    rf"{_H}\.transformer\.decoder\.decoder_layer\.self_attn\."
    rf"attention\.attn\.in_proj_(weight|bias)$")


def _vovnet_rules(key: str):
    """`nn.vovnet.VoVNet`'s keys (the public VoVNet's) -> the JAX
    `VoVNet`'s paths."""
    m = re.match(r"stage(\d)\.OSA\d_(\d+)\.ese\.fc\.(weight|bias)$", key)
    if m:
        n, b, leaf = m.groups()
        path = f"params/stage{n}_{int(b) - 1}/ese/fc"
        return ((f"{path}/kernel", _dense_or_conv1x1) if leaf == "weight"
                else (f"{path}/bias", np.asarray))
    m = re.match(r"stem\.stem_(\d)/(conv|norm)\.(\w+)$", key)
    if m:
        mod, part, leaf = f"stem{m.group(1)}", m.group(2), m.group(3)
    else:
        m = re.match(r"stage(\d)\.OSA\d_(\d+)\.(?:layers\.(\d+)|concat)\."
                     r"OSA[\w]+/(conv|norm)\.(\w+)$", key)
        if m is None:
            return None
        n, b, layer, part, leaf = m.groups()
        inner = "concat" if layer is None else f"layer{layer}"
        mod = f"stage{n}_{int(b) - 1}/{inner}"
    if part == "conv":
        return f"params/{mod}/conv/kernel", _conv
    return _bn_leaf(f"{mod}/norm", leaf)


def _bn_leaf(path: str, leaf: str):
    kind = _BN[leaf]
    return f"{kind[0]}/{path}/{kind[1]}", np.asarray


def _bev_resnet_rules(key: str):
    """`nn.bev_nets.BEVResNet`'s keys -> the JAX `BEVResNet`'s paths."""
    m = re.match(r"layers\.(\d+)\.(\d+)\.(conv|bn)(\d)\.(\w+)$", key)
    if m:
        i, j, part, c, leaf = m.groups()
        path = f"l{i}_{j}/conv{c}"
        if part == "conv":
            return f"params/{path}/conv/kernel", _conv
        return _bn_leaf(f"{path}/norm", leaf)
    m = re.match(r"layers\.(\d+)\.0\.downsample\.(weight|bias)$", key)
    if m:
        i, leaf = m.groups()
        return ((f"params/l{i}_0/downsample/kernel", _conv) if leaf == "weight"
                else (f"params/l{i}_0/downsample/bias", np.asarray))
    return None


def _fpn_lss_rules(key: str):
    """`nn.bev_nets.FPNLSS`'s keys (the reference `FPN_LSS`'s) -> the JAX
    `FPNLSS`'s paths."""
    convs = {"conv.0": "conv1", "conv.3": "conv2", "up2.1": "up_conv"}
    norms = {"conv.1": "conv1", "conv.4": "conv2", "up2.2": "up_conv"}
    mod, _, leaf = key.rpartition(".")
    if mod in convs and leaf == "weight":
        return f"params/{convs[mod]}/conv/kernel", _conv
    if mod in norms and leaf in _BN:
        return _bn_leaf(f"{norms[mod]}/norm", leaf)
    if mod == "up2.4":
        return (("params/up_proj/kernel", _conv) if leaf == "weight"
                else ("params/up_proj/bias", np.asarray))
    return None


# the rules of modules converted on their own (their parameters at the flax
# tree's root), by the port class's name; every other model takes `rule`
MODULE_RULES = {"VoVNet": _vovnet_rules, "BEVResNet": _bev_resnet_rules,
                "FPNLSS": _fpn_lss_rules}


def rule(key: str):
    """(flax path, forward transform) of a port state-dict key, or None."""
    for prefix, fn in (("img_backbone.", _resnet_rules),
                       ("img_neck.", lambda s: _fpn_rules(s, "img_neck")),
                       ("img_lss_neck.", lambda s: _fpn_rules(s, "img_lss_neck"))):
        if key.startswith(prefix):
            return fn(key[len(prefix):])
    return _detector_rules(key)


def _leaf(tree: Dict, path: str) -> np.ndarray:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node)


def _invert(fn, value: np.ndarray, shape) -> np.ndarray:
    if fn is _conv:  # HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if fn is _linear:
        return value.T
    if fn is _dense_or_conv1x1:  # Dense [in, out] -> [out, in] (+ 1x1)
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
    key_rule = MODULE_RULES.get(type(model).__name__, rule)
    for key, ref in model.state_dict().items():
        if keys is not None and key not in keys:
            continue
        if any(p.search(key) for p in IGNORED_KEYS):
            out[key] = ref.detach().clone()
            continue
        m = _IN_PROJ.match(key)
        if m:
            leaf = "kernel" if m.group(1) == "weight" else "bias"
            parts = [_leaf(variables_np, f"params/{_LP}/self_attn/{n}/{leaf}")
                     for n in ("q_proj", "k_proj", "v_proj")]
            value = np.concatenate(
                [p.T if leaf == "kernel" else p for p in parts], axis=0)
        else:
            found = key_rule(key)
            if found is None:
                raise KeyError(f"no flax path for port key {key}")
            path, fn = found
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


def _tensors(sd: Dict) -> Dict:
    return {k: v for k, v in sd.items()
            if torch.is_tensor(v) or isinstance(v, np.ndarray)}


@torch.no_grad()
def load_pretrained(path: str, model: torch.nn.Module, revise_keys=None,
                    state_dict=None) -> torch.nn.Module:
    """Copy into `model`, in place, every tensor of a pretrained checkpoint
    whose name (after `revise_keys`) and shape match one of the model's
    state-dict entries, parameters and BatchNorm statistics alike; the
    entries the config recomputes (`IGNORED_KEYS`) are skipped. `path` is a
    `.pth` / `.pt` file (its `state_dict` entry or the file itself) or a
    pickle of numpy arrays (one that holds JAX objects is refused); pass
    `state_dict` to reuse an already loaded one. Prints the number of keys
    not converted and the first of them, as the JAX package's
    `load_pretrained` does, and returns the model."""
    if state_dict is not None:
        sd = _tensors(state_dict)
    elif path.endswith((".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = _tensors(ckpt.get("state_dict", ckpt))
    else:
        with open(path, "rb") as f:
            sd = _tensors(NumpyOnlyUnpickler(f).load())
    own = model.state_dict()
    loaded, unmatched = 0, []
    for key, val in apply_revise_keys(sd, revise_keys).items():
        if any(p.search(key) for p in IGNORED_KEYS):
            continue
        if key not in own:
            unmatched.append(key)
            continue
        val = torch.as_tensor(val)
        if tuple(val.shape) != tuple(own[key].shape):
            unmatched.append(f"{key} (shape {tuple(val.shape)} vs "
                             f"{tuple(own[key].shape)})")
            continue
        own[key].copy_(val)
        loaded += 1
    print(f"[convert_weights] {loaded} tensors loaded from {path}")
    if unmatched:
        print(f"[convert_weights] {len(unmatched)} keys not converted "
              f"(first: {unmatched[:3]})")
    return model
