"""Config system of the port: a copy of `racformer_tpu/config.py` (standard
library only), so that the port reads configs without importing the JAX
package. The port's configs are its own, in `racformer_tpu_torch/configs/`
(byte-equal copies of the JAX package's); `tests/test_torch_config.py`
holds the copies and the two loaders equal. Python-file configs with
`_base_` inheritance and dotted CLI overrides, the public surface of mmcv's
`Config`.

A config file is a python file whose module-level names become the config
dict. `_base_ = ['other.py']` merges parent configs (dict-deep, child wins).
`Config.merge_override(["a.b=1", "c=[2,3]"])` applies CLI `--override` pairs.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Sequence


def _deep_merge(base: Dict, child: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config(dict):
    """A dict with attribute access, mirroring mmcv's Config surface."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[k] = v
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(path)
        ns: Dict[str, Any] = {"__file__": path}
        with open(path) as f:
            src = f.read()
        code = compile(src, path, "exec")
        exec(code, ns)  # configs are trusted project files, like the reference

        cfg: Dict[str, Any] = {
            k: v
            for k, v in ns.items()
            if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
        }
        bases = cfg.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            bpath = os.path.join(os.path.dirname(path), b)
            merged = _deep_merge(merged, cls.fromfile(bpath))
        merged = _deep_merge(merged, cfg)
        return cls(merged)

    def merge_override(self, pairs: Sequence[str]) -> "Config":
        """Apply `key.sub=value` overrides (values parsed as python literals,
        falling back to strings), mirroring mmcv DictAction."""
        for pair in pairs or []:
            key, _, raw = pair.partition("=")
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                val = raw
            node: Dict = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
        return self

    def dump(self) -> str:
        import pprint

        return pprint.pformat(dict(self), width=100)
