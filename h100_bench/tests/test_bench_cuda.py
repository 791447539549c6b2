"""On the card: a short run of each cell through `run.py` comes out
correct, and the control does not. Skips without a CUDA card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def run(cell, *extra):
    p = subprocess.run([sys.executable, str(ROOT / "h100_bench" / "run.py"),
                        "--workload", cell, "--seed", str(2**31 + 77),
                        "--seconds", "3", "--trace", "0", *extra],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_the_control_is_not(card, cell):
    assert run(cell)["correct"]
    assert not run(cell, "--control")["correct"]
