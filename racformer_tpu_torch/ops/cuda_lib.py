"""Build and load the port's CUDA kernels: `nvcc` compiles each source of
`racformer_tpu_torch/csrc/` into a shared library with a plain C interface,
which `ctypes` loads (`KERNELS` lists them with their entry points).

The library goes to `build/racformer_tpu_torch/` in the repository root and
is named by a hash of its sources, the `csrc/` headers they include and the
flags, so an edited source or header rebuilds and an unchanged one loads the
library already built. A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "racformer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _CI, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry name -> (source in csrc/, C entry point, its argument types); each
# source is one library, named after it, so `build_all` runs one nvcc per
# source at once
KERNELS = {
    "gather_fold": ("gather_fold.cu", "racformer_gather_fold",
                    [_CI] + [_VP] * 7 + [_CI, _I64, _CI, _CI, _CI, _CI, _VP]),
    "patch_gather": ("patch_gather.cu", "racformer_patch_gather",
                     [_CI] + [_VP] * 6 + [_CI, _I64, _CI, _CI, _CI, _VP]),
    "patch_scatter": ("patch_scatter.cu", "racformer_patch_scatter",
                      [_CI] + [_VP] * 10 + [_CI] * 5 + [_VP]),
    "bucket_rows": ("patch_scatter.cu", "racformer_bucket_rows",
                    [_VP] * 7 + [_CI] * 3 + [_VP]),
    "patch_corner_grads": ("patch_corner_grads.cu",
                           "racformer_patch_corner_grads",
                           [_CI] + [_VP] * 8 + [_CI, _I64, _CI, _CI, _CI, _VP]),
    "lap_assign": ("lap_assign.cu", "racformer_lap_assign",
                   [_VP] * 3 + [_CI] * 3 + [_VP]),
}

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc output (ptxas register/spill report)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return nvcc


def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Return the loaded library `name` built from `sources` (file names in
    `csrc/`), compiling it first if no library of the same hash exists."""
    if name in _loaded:
        return _loaded[name]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        text = (CSRC / src).read_bytes()
        digest.update(text)
        # the csrc headers it includes (they include none of their own)
        for header in re.findall(rb'#include "([^"]+)"', text):
            digest.update((CSRC / header.decode()).read_bytes())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(CSRC / s) for s in sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {name} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        os.replace(tmp, lib_path)
    _loaded[name] = ctypes.CDLL(str(lib_path))
    return _loaded[name]


def function(name: str):
    """The C entry point `name` (a key of `KERNELS`) of its source's
    library, built and loaded at first use, with its argument types set."""
    source, symbol, argtypes = KERNELS[name]
    fn = getattr(load(Path(source).stem, (source,)), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def build_all() -> None:
    """Build (or load) every kernel library now, one nvcc per source, all
    started together."""
    one_per_source = {src: name for name, (src, _, _) in KERNELS.items()}
    with ThreadPoolExecutor(len(one_per_source)) as pool:
        for _ in pool.map(function, one_per_source.values()):
            pass
    for name in KERNELS:
        function(name)
