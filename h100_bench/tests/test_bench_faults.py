"""The comparison that decides `correct` fails what it must: each fault
the cell can have (`faults.py`), planted under a whole run at a tiny size
on the CPU, at the cell's own limits, and the control (the program's own
bf16 head in place of the f32 one). The sound run passes."""

import pytest
import torch

from h100_bench import check, faults
from h100_bench.tests import tiny
from h100_bench.traffic import generator

CELLS = ("flagship.stream", "front3.stream", "flagship.lockstep4", "flagship.train")
CASES = [(c, f) for c in CELLS
         for f in faults.BY_KIND[generator.load_mix(tiny.traffic(c))["kind"]]]


@pytest.fixture(autouse=True)
def small(monkeypatch):
    tiny.tiny_mixes(monkeypatch)


@pytest.mark.parametrize("cell,fault", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_fails_the_check(cell, fault):
    r = tiny.run(cell, fault=fault, limits=check.load_limits(cell))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_run_passes_the_cells_limits(cell):
    r = tiny.run(cell, limits=check.load_limits(cell))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    """At the tiny cut the port and the reference agree to rounding
    (`tiny.LIMITS`); the control's bf16 head does not. At the cells' own
    size and limits the control is read on the card (`run.py --control`,
    PERF.md section 2)."""
    sound = tiny.run(cell)
    assert sound["correct"], sound["checks"]
    control = tiny.run(cell, overrides={"head_dtype": torch.bfloat16})
    assert not control["correct"], control["checks"]
