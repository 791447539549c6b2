"""A configuration names its image trunk (`img_backbone`), and the frozen
reference builds it from a file of `reference/nn/`.

* With no trunk named, the flagship's and front3's reference trees draw
  the same leaves, in the same order and by the same rules, as before the
  trunk could be named: every cell's seeded weights stay as they were.
* VoVNet-99 at 1600x640 builds with every leaf drawn, and its pyramid
  fits the necks at every level.
* The reference's VoVNet equals the port's (`racformer_tpu_torch/nn/
  vovnet.py`) on the same weights.
* A new trunk is one new file: a copy of the benchmark gains one, and a
  configuration that names it runs through the reference.
"""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100_bench import harness, weights
from h100_bench.reference.model import RaCFormer, config_kwargs
from h100_bench.reference.model.racformer import build_trunk
from h100_bench.reference.nn import vovnet as ref_vovnet

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
VOV99 = {"type": "VoVNet", "spec_name": "V-99-eSE"}
# sha256 of `weights.leaf_rules` (names, shapes, order, std, offset, uniform)
# as JSON, recorded from the reference before `img_backbone` existed; the
# flagship and front3 differ in cameras only, which no leaf depends on
RULES_DIGEST = "ed062cea9f46833aea8455f9a70a5438660bf7239552e1a37d167ccbfd95e8df"
# two blocks a stage, so the identity path is taken (as the port's test has it)
NARROW = dict(stem=(16, 16, 32), stage_conv=(16, 24, 32, 40),
              stage_out=(32, 48, 64, 80), layers=2, blocks=(2, 2, 2, 2))


def skeleton(cfg):
    with torch.device("meta"):
        return RaCFormer(**harness.model_kwargs(cfg, config_kwargs))


def vov99_cfg():
    cfg = harness.load_config(harness.load_benchmark(), "flagship")
    cfg["model"].update(img_backbone=VOV99, image_hw=[640, 1600])
    return cfg


@pytest.mark.parametrize("name", ["flagship", "front3"])
def test_no_trunk_named_draws_the_parents_leaves(name):
    cfg = harness.load_config(harness.load_benchmark(), name)
    assert "img_backbone" not in cfg["model"]
    rules = weights.leaf_rules(skeleton(cfg))
    assert hashlib.sha256(json.dumps(rules).encode()).hexdigest() == RULES_DIGEST


def test_vovnet99_at_1600x640_builds_with_every_leaf_drawn():
    model = skeleton(vov99_cfg())
    assert type(model.img_backbone) is ref_vovnet.VoVNet
    assert [m.conv.in_channels for m in model.img_neck.lateral_convs] == [256, 512, 768, 1024]
    assert [m.conv.in_channels for m in model.img_lss_neck.lateral_convs] == [768, 1024]
    rules = weights.leaf_rules(model)
    weights.load(model, {n: torch.empty(s, device="meta") for n, s, *_ in rules})
    with torch.device("meta"):
        feat_cat, lss_feat = model._trunk(torch.empty(1, 6, 640, 1600, 3))
    assert tuple(lss_feat.shape) == (1, 6, 40, 100, 256)


def test_an_unknown_trunk_is_refused_by_name():
    for spec, says in (({"type": "NoSuchTrunk"}, "NoSuchTrunk"),
                       ({"type": "vovnet"}, "defines no class"),
                       ({"type": "../nn/vovnet"}, "no trunk file"),
                       ({"spec_name": "V-99-eSE"}, "None")):
        with pytest.raises(ValueError, match=says):
            build_trunk(spec, torch.float32)


def drawn(module, seed):
    """`module`'s state dict with every leaf drawn by `weights.leaf_rules`."""
    gen = torch.Generator().manual_seed(seed)
    state = module.state_dict()
    for name, shape, std, offset, uniform in weights.leaf_rules(module):
        state[name] = offset + (torch.rand(shape, generator=gen) if uniform
                                else std * torch.randn(shape, generator=gen))
    return state


def test_reference_vovnet_equals_the_ports(monkeypatch):
    """Equal bit for bit in float32, eval and train mode (the BatchNorm is
    frozen), gradients too: the same operations in the same order on the
    same CPU, and the port's checkpointed blocks recompute the same
    numbers. Every real spec has the port's state-dict names and shapes."""
    from racformer_tpu_torch.nn import vovnet as port_vovnet

    monkeypatch.setitem(port_vovnet.SPECS, "narrow", NARROW)
    monkeypatch.setitem(ref_vovnet.SPECS, "narrow", NARROW)
    port = port_vovnet.VoVNet("narrow", remat=True)
    ref = ref_vovnet.VoVNet("narrow")
    port.load_state_dict(drawn(port, 11))
    ref.load_state_dict(port.state_dict())  # strict: the same names
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        got, want = ref.eval()(x), port.eval()(x)
    assert ref.out_channels == tuple(w.shape[-1] for w in want) == (32, 48, 64, 80)
    for g, w in zip(got, want):
        assert w.std() > 1e-3 and torch.equal(g, w)
    for m in (port.train(), ref.train()):
        sum(o.square().sum() for o in m(x)).backward()
    for (name, a), (_, b) in zip(ref.named_parameters(), port.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
    for spec in port_vovnet.SPECS:
        with torch.device("meta"):
            a, b = ref_vovnet.VoVNet(spec).state_dict(), port_vovnet.VoVNet(spec).state_dict()
        assert [(n, t.shape) for n, t in a.items()] == [(n, t.shape) for n, t in b.items()]


TRUNK_FILE = '''"""A trunk for a test: four strided 3x3 convs."""
import torch
from .layers import Conv2d


class TinyTrunk(torch.nn.Module):
    def __init__(self, width=8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_channels = tuple(width << i for i in range(4))
        self.convs = torch.nn.ModuleList(
            Conv2d(cin, c, 3, stride=4 if i == 0 else 2)
            for i, (cin, c) in enumerate(zip((3,) + self.out_channels, self.out_channels)))

    def forward(self, x):
        outs, x = [], x.to(self.dtype)
        for conv in self.convs:
            x = torch.relu(conv(x))
            outs.append(x)
        return tuple(outs)
'''

NEW_TRUNK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from h100_bench import harness
from h100_bench.reference.eval.decode import decode_config
from h100_bench.reference.streaming import WindowReference
from h100_bench.tests import tiny
from h100_bench.traffic import generator
cfg = tiny.tiny_cfg()
cfg["model"]["img_backbone"] = {"type": "TinyTrunk", "width": 12}
model = harness.build_reference(cfg, harness.reference_state(cfg, 3, "cpu"), "cpu")
mix = dict(generator.load_mix("stream"), **tiny.TINY_MIX)
tape = generator.tape(mix, 3, 0, 3)
cls, boxes, _ = WindowReference(model, generator.frame_pool(cfg, mix, 3), [tape],
                                decode_config(cfg.get("eval_cfg")), "cpu").window(2)
print(json.dumps({"file": sys.modules[type(model.img_backbone).__module__].__file__,
                  "widths": [m.conv.in_channels for m in model.img_neck.lateral_convs],
                  "finite": bool(torch.isfinite(cls).all() and torch.isfinite(boxes).all()),
                  "program": sorted({m.split(".")[0] for m in sys.modules}
                                    & {"racformer_tpu_torch", "racformer_tpu", "jax"})}))
"""


def test_a_new_trunk_is_one_new_file(tmp_path):
    """A copy of the benchmark gains `reference/nn/tinytrunk.py`; a
    configuration naming `TinyTrunk` builds, draws and runs the reference
    from that file, with no other file of the copy changed and nothing of
    the program loaded."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "h100_bench"
    (b / "reference" / "nn" / "tinytrunk.py").write_text(TRUNK_FILE)
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    p = subprocess.run([sys.executable, "-c", NEW_TRUNK, str(tmp_path)],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert Path(r["file"]) == b / "reference" / "nn" / "tinytrunk.py"
    assert r["widths"] == [12, 24, 48, 96] and r["finite"] and r["program"] == []
    for q, data in before.items():
        assert (b / q.relative_to(BENCH)).read_bytes() == data
