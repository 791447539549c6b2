"""Build and load the port's CUDA kernels: `nvcc` compiles sources from
`racformer_tpu_torch/csrc/` into a shared library with a plain C interface,
which `ctypes` loads.

The library goes to `build/racformer_tpu_torch/` in the repository root and
is named by a hash of its sources and flags, so an edited source rebuilds
and an unchanged one loads the library already built. A build failure
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "racformer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        digest.update((CSRC / src).read_bytes())
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
