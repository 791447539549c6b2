"""The port's own copies of JAX-free code of the JAX package, held equal to
the originals:

* `racformer_tpu_torch.config.Config` reads every config of
  `racformer_tpu/configs/` (those with `_base_` included) to the same dict
  as `racformer_tpu.config.Config`, and applies overrides the same way;
* the port's configs (`racformer_tpu_torch/configs/`) are byte-equal
  copies of those, file for file, and read to the same dicts;
* the rule tables of `racformer_tpu_torch.tools.convert_weights` map every
  state-dict key of the flagship port model to the same flax path and the
  same layout transform as `racformer_tpu.tools.convert_weights`.
"""

import pathlib

import pytest
import torch

from racformer_tpu import config as jconfig
from racformer_tpu.tools import convert_weights as jcw

from racformer_tpu_torch import config as tconfig
from racformer_tpu_torch.model import RaCFormer
from racformer_tpu_torch.tools import convert_weights as tcw

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "racformer_tpu" / "configs").glob("*.py"))
PORT_CONFIGS = REPO / "racformer_tpu_torch" / "configs"


def test_configs_with_base_exist():
    assert any("_base_" in p.read_text() for p in CONFIGS)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_loader_matches_jax_package(path):
    got = tconfig.Config.fromfile(str(path))
    want = jconfig.Config.fromfile(str(path))
    assert dict(got) == dict(want)
    assert "_base_" not in got
    over = ["optimizer.base_lr=1e-5", "model.num_query=17", "new.key=[1, 2]"]
    assert dict(got.merge_override(over)) == dict(want.merge_override(over))


def test_port_holds_every_config():
    assert sorted(p.name for p in PORT_CONFIGS.glob("*.py")) == [
        p.name for p in CONFIGS]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_port_config_is_a_copy(path):
    copy = PORT_CONFIGS / path.name
    assert copy.read_bytes() == path.read_bytes()
    got = tconfig.Config.fromfile(str(copy))
    assert dict(got) == dict(jconfig.Config.fromfile(str(path)))


def _jax_rule(key):
    for prefix, mod in (("img_backbone.", None), ("img_neck.", "img_neck"),
                        ("img_lss_neck.", "img_lss_neck")):
        if key.startswith(prefix):
            src = key[len(prefix):]
            return jcw._resnet_rules(src) if mod is None else jcw._fpn_rules(src, mod)
    return jcw._detector_rules(key)


def test_rule_tables_match_jax_package():
    with torch.device("meta"):
        model = RaCFormer()
    n = 0
    for key in model.state_dict():
        ignored = any(p.search(key) for p in tcw.IGNORED_KEYS)
        assert ignored == any(p.search(key) for p in jcw.IGNORED_KEYS), key
        got, want = tcw.rule(key), _jax_rule(key)
        if ignored or tcw._IN_PROJ.match(key):
            continue
        assert got is not None and want is not None, key
        assert got[0] == want[0], key
        assert got[1].__name__ == want[1].__name__, key
        n += 1
    assert n > 400  # 497 at the flagship config
