#!/usr/bin/env python3
"""The H100 benchmark of `racformer_tpu_torch`: one run of one cell.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs from any directory (the repository is found from this file's path) on
a machine with as many CUDA cards as the cell asks for. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), `device`, with `--trace 1` `breakdown`, and last `checks`, each
number compared with its limit (also the last lines of standard error).

No result is printed, and the exit code is not 0, when there is no CUDA
card or too few, when the program (`racformer_tpu_torch`) cannot be
imported, or when JAX, flax or the JAX package was loaded. Any other
failure, a hang included (a watchdog thread), prints the line with
`correct` false and exits 1.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "racformer_tpu")
DEADLINE_S = 340  # a run must end within 360 s
FIRST_DEADLINE_S = 1140  # the first run of a checkout builds the kernels
_printed = threading.Lock()


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def emit(result: dict) -> None:
    """The result line (once per process), the compared numbers last on
    standard error."""
    if not _printed.acquire(blocking=False):
        return
    for name, v in result.get("readings", {}).items():
        print(f"reading {name}: {v!r}", file=sys.stderr)
    for name, c in result.get("checks", {}).items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(plain(result)), flush=True)


def plain(obj):
    """`obj` with every number JSON cannot hold (inf, nan) as its text."""
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


def failure(reason: str, device_kind: str = "unknown") -> dict:
    return {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
            "device": {"platform": "gpu", "kind": device_kind, "count": 0,
                       "memory_peak_bytes": 0},
            "checks": {"run_completed": {"value": reason, "limit": "completed"}}}


def watchdog(seconds: float) -> None:
    def fire():
        print(f"h100_bench: no result after {seconds:.0f} s; giving up",
              file=sys.stderr)
        emit(failure(f"timed out after {seconds:.0f} s"))
        os._exit(1)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()


def kernels_built() -> bool:
    return any((ROOT / "build" / "racformer_tpu_torch").glob("libgather_fold-*.so"))


def no_result(msg: str, code: int = 2):
    print(f"h100_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def environment() -> None:
    """The caches inside the checkout, no flax, one host compute thread."""
    for sub in ("torch_extensions", "triton"):
        (ROOT / "build" / sub).mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    # one process with one compute thread on the host: the step's host work
    # is Python dispatch, and idle pool threads only contend for the cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def pin_card() -> str:
    """Float32 precision pinned (both flags printed), the card and its power
    limit printed; returns the card's name."""
    import torch
    from racformer_tpu_torch.utils.precision import pin_float32_precision

    pin_float32_precision(lambda line: print(line, file=sys.stderr))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader"
                   " 2>/dev/null").read().strip().splitlines()
    print(f"card: {smi[0] if smi else 'nvidia-smi gave nothing'}", file=sys.stderr)
    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the control (the program's bf16 head) instead; "
                         "its numbers must fail the limits")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of h100_bench/faults.py under the timed "
                         "path; `correct` must come out false")
    args = ap.parse_args(argv)

    environment()
    if not (ROOT / "racformer_tpu_torch").is_dir():
        no_result(f"the program racformer_tpu_torch is not in {ROOT}")
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        chips = next(w["chips"] for w in bench["workloads"]
                     if w["name"] == args.workload)
    except (OSError, StopIteration, KeyError, ValueError) as e:
        no_result(f"no workload {args.workload!r}: {e!r}")

    watchdog(DEADLINE_S if kernels_built() else FIRST_DEADLINE_S)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        no_result("torch.cuda.is_available() is false: the benchmark needs a CUDA card")
    if torch.cuda.device_count() < chips:
        no_result(f"{torch.cuda.device_count()} CUDA cards, the cell asks for {chips}")
    try:
        import racformer_tpu_torch  # noqa: F401
    except ImportError as e:
        no_result(f"the program cannot be imported: {e!r}")

    kind = pin_card()
    try:
        from h100_bench import harness

        from h100_bench.faults import FAULTS

        overrides = {"head_dtype": torch.bfloat16} if args.control else None
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_PROCESS,
                                  bench=bench, overrides=overrides,
                                  fault=FAULTS[args.fault] if args.fault else None)
    except Exception:
        traceback.print_exc()
        emit(failure(traceback.format_exc(limit=1).strip().splitlines()[-1][:300], kind))
        return 1
    found = forbidden_modules(sys.modules)
    if found:
        no_result(f"modules of JAX or the JAX package were loaded: {found}", 3)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
