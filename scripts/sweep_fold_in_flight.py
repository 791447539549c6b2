#!/usr/bin/env python3
"""Time the fold gather K1 (`racformer_tpu_torch/csrc/gather_fold.cu`) with
other counts of points in flight per lane group, on one NVIDIA GPU.

    python3 scripts/sweep_fold_in_flight.py [--in-flight 4,8,4x2]

For each variant N (or NxB) it builds one library of the kernel, the
source's `kInFlight` set to N and its `kMinBlocks`, the resident blocks per
SM that the kernel's `__launch_bounds__` ask of ptxas (which caps its
registers), set to B (1 without xB), both in both dtypes, with the flags of
`racformer_tpu_torch.ops.cuda_lib`, into `build/sweep_fold/`, and prints
what ptxas reports of it. Then, at the
three decoder sites' flagship shapes of `chip_smoke.py` phase 3 (seeded
random maps and points), in f32 and bf16, it checks every variant against
the plain version and prints its median time, the variants timed in turns
(A B ... B A) and both turns printed.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from racformer_tpu_torch.ops import cuda_lib  # noqa: E402
from racformer_tpu_torch.ops import gather_kernel as gk  # noqa: E402

OUT = REPO / "build" / "sweep_fold"


def build(variant):
    """The library of K1 variant "N" or "NxB"; ptxas's report."""
    n, _, blocks = variant.partition("x")
    OUT.mkdir(parents=True, exist_ok=True)
    text = (cuda_lib.CSRC / "gather_fold.cu").read_text()
    for name, value in (("kInFlight", n), ("kMinBlocks", blocks or "1")):
        text, found = re.subn(rf"constexpr int {name} = [^;]+;",
                              f"constexpr int {name} = {value};", text)
        if found != 1:
            raise RuntimeError(f"{name} not found once in gather_fold.cu")
    src = OUT / f"gather_fold_{variant}.cu"
    src.write_text(text)
    (OUT / "point_tiles.cuh").write_bytes(
        (cuda_lib.CSRC / "point_tiles.cuh").read_bytes())
    lib = OUT / f"libgather_fold_{variant}.so"
    proc = subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).racformer_gather_fold
    fn.argtypes = cuda_lib.KERNELS["gather_fold"][2]
    fn.restype = ctypes.c_int
    return fn, chip_smoke.ptxas_report(proc.stdout + proc.stderr, True)


def call(fn, fmap, pts, fold):
    """One launch of a variant, as `gather_kernel.patch_sample_fold` makes
    it."""
    S, R, Wp, C2 = fmap.shape
    row, x0p, wx, wy, wl = pts
    out = torch.empty((S, row.shape[1] // fold, C2 // 2), dtype=fmap.dtype,
                      device=fmap.device)
    err = fn(gk.dtype_code("sweep", fmap.dtype), fmap.data_ptr(),
             row.data_ptr(), x0p.data_ptr(), wx.data_ptr(), wy.data_ptr(),
             wl.data_ptr(), out.data_ptr(), S, R * Wp * C2, Wp, C2 // 2,
             row.shape[1], fold, gk.current_stream(fmap))
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--in-flight", default="4,8",
                        help="comma-separated variants: points in flight N, "
                             "or NxB with B blocks per SM asked of ptxas")
    variants = parser.parse_args(argv).in_flight.split(",")
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = chip_smoke.phase_card()
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(build, variants)))
    for v, (_, report) in built.items():
        for line in report:
            print(f"variant {v}: {line}")
    _, _, model = chip_smoke.flagship_model(dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    order = variants + variants[::-1]
    for dtype in (torch.float32, torch.bfloat16):
        for name, fmap, pts, fold, _ in chip_smoke.site_cases(model, gen, dtype, dev):
            want = gk.patch_sample_fold_reference(fmap, *pts, fold)
            times = {v: [] for v in variants}
            for v in variants:
                ok, err, tol = chip_smoke.fold_ok(call(built[v][0], fmap, pts, fold),
                                                  want)
                if not ok:
                    sys.exit(f"variant {v} disagrees with the plain version at "
                             f"{name} {dtype}: {err:.3g} ({tol})")
            for v in order:
                times[v].append(chip_smoke.median_ms(
                    lambda: call(built[v][0], fmap, pts, fold)))
            print(f"{card} | K1 {name:9s} {str(dtype):14s} fold={fold}: " + ", ".join(
                f"variant {v} {' / '.join(f'{t:.4f}' for t in times[v])} ms"
                for v in variants))


if __name__ == "__main__":
    main(sys.argv[1:])
