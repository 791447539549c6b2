"""The frozen reference against the port at a tiny cut on the CPU (where
the port takes its kernels' plain versions too), and the reference's
independence: it loads no module of the port, of JAX or of the JAX
package."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.reference.eval.decode import decode_config
from h100_bench.reference.streaming import WindowReference
from h100_bench.tests import tiny
from h100_bench.traffic import generator

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def small(monkeypatch):
    tiny.tiny_mixes(monkeypatch)


def test_reference_windows_equal_the_ports_streaming_steps():
    cfg = tiny.tiny_cfg()
    mix = generator.load_mix("stream")
    pool = generator.frame_pool(cfg, mix, 5)
    state = harness.reference_state(cfg, 5, "cpu")
    model, ev = harness.build_program(cfg, state, "cpu")
    tape = generator.tape(mix, 5, 0, 9)
    ref = WindowReference(harness.build_reference(cfg, state, "cpu"), pool,
                          [tape], decode_config(cfg.get("eval_cfg")), "cpu")
    assert sum(e[1] for e in tape) >= 2  # a scene boundary inside
    for i, entry in enumerate(tape):
        if entry[1]:
            ev.reset()
        got = ev.step(harness.frame_at(pool, entry), blocking=True)
        _, _, want = ref.window(i)
        for k in ("scores", "bboxes", "labels", "valid"):
            np.testing.assert_allclose(got[k][0], want[k][0].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"frame {i} {k}")


def test_reference_train_steps_equal_the_ports():
    r = tiny.run("flagship.train")
    assert r["correct"], r["checks"]
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert r["checks"][k]["value"] < 1e-6, (k, r["checks"])


def test_every_stream_cell_passes_its_tiny_run():
    for cell in ("flagship.stream", "front3.stream", "flagship.lockstep4"):
        r = tiny.run(cell, trace=True)
        assert r["correct"], (cell, r["checks"])
        assert r["checks"]["score_gap"]["value"] < 1e-3


def test_the_reference_and_the_harness_load_no_program_module():
    code = ("import sys; import h100_bench.harness, h100_bench.flops, "
            "h100_bench.reference.model, h100_bench.reference.train, "
            "h100_bench.reference.streaming, h100_bench.reference.nn.vovnet; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'racformer_tpu', 'racformer_tpu_torch'}); "
            "print(bad)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
    imports = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|racformer_tpu|racformer_tpu_torch)\b",
        re.MULTILINE)
    for path in (ROOT / "h100_bench" / "reference").rglob("*.py"):
        assert not imports.search(path.read_text()), path


def test_weights_cover_every_leaf_and_repeat_by_seed():
    cfg = tiny.tiny_cfg()
    a = harness.reference_state(cfg, 2**35 + 1, "cpu")
    b = harness.reference_state(cfg, 2**35 + 1, "cpu")
    c = harness.reference_state(cfg, 2**35 + 2, "cpu")
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    harness.build_reference(cfg, a, "cpu")  # raises on a leaf left undrawn
