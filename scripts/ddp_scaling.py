#!/usr/bin/env python3
"""Phases 15 and 16 of `chip_smoke.py` alone, at world 1 and on every card
of the machine, with the scaling between the two:

    python3 scripts/ddp_scaling.py

It prints the card's name and power limit, turns TF32 off and prints both
flags (phase 1, `racformer_tpu_torch/utils/precision.py`, as the drivers
it runs do in every rank), builds the kernels (phase 2),
runs the train driver under torchrun (phase 15) and the eval driver's
offline and 4-stream protocols under torchrun (phase 16) at each world,
and prints each world's train samples/s and eval rates against world 1's.
The smoke script runs the same phases on the same worlds among all its
others; this script gives the scaling on a machine of several cards in a
fraction of that run. Exits non-zero if a phase fails.
"""

from __future__ import annotations

import runpy
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main():
    card = chip_smoke.phase_card()
    chip_smoke.phase_build()
    chip_smoke.phase_ddp_worlds(runpy.run_path(str(chip_smoke.CONFIG)), card)


if __name__ == "__main__":
    try:
        main()
    except chip_smoke.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
