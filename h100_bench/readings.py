#!/usr/bin/env python3
"""The readings a cell's limits are set from: many seeds of one cell in
one process, sound, as the control or with a planted fault, each printed
as one JSON line of its compared numbers (`checks`, against the limits in
force) and its readings.

    python3 h100_bench/readings.py --workload <name> --seed <first> --seconds <s> \\
        sound:12 control:3 wrong_labels:3 ...

Seeds run from `--seed` up, one a run, across all the modes. A mode is
`sound`, `control` (the program's bf16 head) or a fault of `faults.py`.
One process pays the set-up once; each run builds its own weights, inputs
and program from its seed as `run.py` does. No result line of the
contract is printed: this is not the benchmark's command."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench.run import environment, pin_card, plain  # noqa: E402


def runs(spec):
    """["sound:12", "control:3"] -> [("sound", 12), ("control", 3)]."""
    out = []
    for item in spec:
        mode, _, n = item.partition(":")
        out.append((mode, int(n or 1)))
    return out


def read_many(cell, first_seed, seconds, spec, device, **kw):
    """Yields one record a run: mode, seed, correct, checks, readings."""
    import torch

    from h100_bench import harness
    from h100_bench.faults import FAULTS

    seed = first_seed
    for mode, n in runs(spec):
        for _ in range(n):
            overrides = {"head_dtype": torch.bfloat16} if mode == "control" else None
            fault = FAULTS[mode] if mode not in ("sound", "control") else None
            r = harness.run_cell(cell, seed, seconds, False, device,
                                 time.perf_counter(), overrides=overrides,
                                 fault=fault, **kw)
            yield {"mode": mode, "seed": seed, "correct": r["correct"],
                   "failed": r["failed"], "checks": r["checks"],
                   "readings": r["readings"]}
            seed += 1
            harness.free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("runs", nargs="+", help="mode:count, mode one of sound, "
                                            "control or a fault's name")
    args = ap.parse_args(argv)
    environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    pin_card()
    for rec in read_many(args.workload, args.seed, args.seconds, args.runs, "cuda:0"):
        print(json.dumps(plain(rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
