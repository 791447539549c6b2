"""Parameter names, weight conversion and import hygiene of the PyTorch
port.

* At the flagship config the port's state dict has exactly the reference
  checkpoint's keys and shapes (`tests/reference_keyset.py`).
* JAX -> port conversion is the exact inverse of the JAX package's
  port -> JAX converter: a round trip returns every tensor bit for bit.
* Importing any module of the port (the train and eval drivers, the data
  layer and the config loader included) loads neither jax, flax, the JAX
  package `racformer_tpu`, Pillow nor matplotlib; its sources and
  `chip_smoke.py` import none of them (Pillow only inside the functions
  that decode or write images, matplotlib inside those that draw) and
  use no fused-attention operator, `torch.compile` or kernel library;
  nor do they name a path under `racformer_tpu/` to open (configs are read
  from the port's copies): only docstrings naming an original, and
  `file:line` citations of an original's kernel, name one.
"""

import ast
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.tools.convert_weights import convert_state_dict

from racformer_tpu_torch.model import RaCFormer, random_init_
from racformer_tpu_torch.tools.convert_weights import state_dict_from_jax
from tests.reference_keyset import full_reference_keyset

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(num_cams=2, num_frames=2, embed_dims=256, num_query=12,
            num_clusters=2, image_hw=(64, 128), depth_bins=16,
            bev_size=(32, 32), num_decoder_layers=2)


def test_flagship_state_dict_matches_reference_keyset():
    with torch.device("meta"):
        model = RaCFormer()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = full_reference_keyset()
    assert sorted(set(got) - set(want)) == []
    assert sorted(set(want) - set(got)) == []
    bad = {k: (got[k], want[k]) for k in want if got[k] != tuple(want[k])}
    assert bad == {}


def test_weight_round_trip_is_exact():
    model = RaCFormer(**TINY, trunk_dtype=torch.float32)
    random_init_(model, torch.Generator().manual_seed(3))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}

    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32, train_mode=False)
    B, T, N, H, W, P = 1, 2, 2, 64, 128, 8
    args = (jnp.zeros((B, T, N, H, W, 3)), jnp.zeros((B, T, P, 7)),
            jnp.ones((B, T, P), bool), jnp.zeros((B, T, N, H, W)),
            jnp.zeros((B, T, N, H, W)), jnp.tile(jnp.eye(4), (B, T, N, 1, 1)),
            jnp.tile(jnp.eye(4), (B, T, N, 1, 1)), jnp.zeros((B, T)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, unmatched = convert_state_dict(sd, template, strict=True)
    assert unmatched == []

    back = state_dict_from_jax(variables, model)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_import_leaves_jax_out():
    """Every module of the port, the drivers, the data layer and the tools
    included, imports without loading JAX, the JAX package, Pillow or
    matplotlib (the data modules import Pillow only where they decode an
    image, the tools matplotlib only where they draw)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "racformer_tpu_torch").rglob("*.py"))
    for name in ("racformer_tpu_torch.eval.__main__",
                 "racformer_tpu_torch.eval.offline",
                 "racformer_tpu_torch.eval.metrics",
                 "racformer_tpu_torch.eval.kitti_eval",
                 "racformer_tpu_torch.data.nuscenes",
                 "racformer_tpu_torch.data.native",
                 "racformer_tpu_torch.train.hostdata",
                 "racformer_tpu_torch.train.hooks",
                 "racformer_tpu_torch.train.checkpoint",
                 "racformer_tpu_torch.train.__main__",
                 "racformer_tpu_torch.data.prefetch",
                 "racformer_tpu_torch.utils.logging",
                 "racformer_tpu_torch.tools.convert_weights",
                 "racformer_tpu_torch.tools.export_results",
                 "racformer_tpu_torch.tools.gen_sweep_info",
                 "racformer_tpu_torch.tools.eval_plots",
                 "racformer_tpu_torch.tools.visualize",
                 "racformer_tpu_torch.tools.profile_gpu",
                 "racformer_tpu_torch.tools.vod_smoke"):
        assert name in modules
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'flax', 'orbax', 'racformer_tpu', 'PIL',\n"
            "        'matplotlib')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


CITATION = re.compile(r"racformer_tpu/[\w/]+\.py:\d+")
USAGE = re.compile(r"--[\w-]+[ =]racformer_tpu/")


def jax_package_paths(text):
    """The places where a source names a path under the JAX package
    `racformer_tpu/`: a string, not a docstring, holding `racformer_tpu/`
    (but for a `file:line` citation of an original), the name
    "racformer_tpu" as a part of a path (an operand of `/` or an argument of
    a call such as `os.path.join`), and a usage line passing such a path to
    an option, docstrings included."""
    tree = ast.parse(text)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    found = [m.group(0) for m in USAGE.finditer(text)]
    for node in ast.walk(tree):
        parts = []
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            parts = [node.left, node.right]
        elif isinstance(node, ast.Call):
            parts = list(node.args)
        found += [f"{ast.unparse(node)[:80]}" for part in parts
                  if isinstance(part, ast.Constant)
                  and part.value == "racformer_tpu"]
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs
                and re.search(r"(?<![\w.])racformer_tpu/", node.value)
                and not CITATION.fullmatch(node.value)):
            found.append(node.value[:80])
    return found


@pytest.mark.parametrize("src,bad", [
    ('CONFIG = os.path.join(ROOT, "racformer_tpu", "configs", "a.py")', True),
    ('CONFIG = REPO / "racformer_tpu" / "configs" / "a.py"', True),
    ('open("racformer_tpu/configs/a.py")', True),
    ('x = f"{root}/racformer_tpu/configs/{name}"', True),
    ('"""Usage:\n\n    python -m m --config racformer_tpu/configs/a.py\n"""',
     True),
    ('"""A copy of `racformer_tpu/data/nuscenes.py`."""', False),
    ('def f():\n    """Port of `racformer_tpu/ops/bilinear.py`."""', False),
    ('K = {"replaces": "racformer_tpu/ops/gather_kernel.py:187"}', False),
    ('bad = [m for m in mods if m in ("jax", "racformer_tpu")]', False),
    ('CONFIG = REPO / "racformer_tpu_torch" / "configs" / "a.py"', False),
])
def test_jax_package_path_scan(src, bad):
    assert bool(jax_package_paths(src)) == bad


def test_port_sources_use_no_forbidden_code():
    banned = ("import jax", "from jax", "import flax", "from flax",
              "import orbax", "from orbax",
              "scaled_dot_product_attention", "torch.compile",
              "cpp_extension", "import triton", "flash_attn", "xformers")
    # the JAX package itself, but not the port's own name
    jax_package = re.compile(r"from racformer_tpu\.|from racformer_tpu import"
                             r"|import racformer_tpu(?!_torch)")
    for path in [REPO / "chip_smoke.py",
                 *(REPO / "racformer_tpu_torch").rglob("*.py")]:
        text = path.read_text()
        for b in banned:
            assert b not in text, f"{path.name} contains {b!r}"
        assert not jax_package.search(text), f"{path.name} imports racformer_tpu"
        paths = jax_package_paths(text)
        assert not paths, f"{path.name} names the JAX package's files: {paths}"
        assert not re.search(r"^(from|import) PIL", text, re.M), (
            f"{path.name} imports Pillow at module level")
        assert not re.search(r"^(from|import) matplotlib", text, re.M), (
            f"{path.name} imports matplotlib at module level")
