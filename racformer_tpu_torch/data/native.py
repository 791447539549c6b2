"""ctypes binding for the native data-prep library (compiled on demand).

A copy of `racformer_tpu/data/native.py` that builds the port's own source,
`racformer_tpu_torch/csrc/dataloader.cpp` (a copy of the JAX package's), with
`g++ ... -ljpeg` into `build/racformer_tpu_torch/` of the repository root;
it never loads the JAX package's library. Falls back to the PIL/numpy paths
in `transforms.py` / `depth_maps.py` when the toolchain or libjpeg is
unavailable; `available()` reports which path is live.
`tests/test_torch_data.py` holds it equal to the numpy path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "dataloader.cpp"
_SO = (Path(__file__).resolve().parents[2] / "build" / "racformer_tpu_torch"
       / "libracloader.so")


def _build() -> bool:
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-ljpeg", "-o",
             str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _SO)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.rac_decode_jpeg.restype = ctypes.c_int
    lib.rac_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.rac_resize_crop_flip.restype = None
    lib.rac_resize_crop_flip.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.rac_radar_columns.restype = None
    lib.rac_radar_columns.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def library_path() -> Path:
    """Where the library is built (and loaded from)."""
    return _SO


def decode_jpeg(data: bytes, max_hw=(1000, 1700)) -> Optional[np.ndarray]:
    """Decode JPEG bytes -> RGB uint8 [h, w, 3], or None on failure."""
    lib = _load()
    if lib is None:
        return None
    mh, mw = max_hw
    buf = np.empty((mh, mw * 3), np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.rac_decode_jpeg(
        data, len(data), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mw, mh, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        return None
    out = buf.reshape(-1)[: h.value * w.value * 3]
    return out.reshape(h.value, w.value, 3).copy()


def resize_crop_flip(img: np.ndarray, scale: float, crop_xy: Tuple[int, int],
                     flip: bool, out_hw: Tuple[int, int],
                     to_bgr: bool = True) -> np.ndarray:
    """Fused resize+crop+flip(+RGB->BGR) -> float32 [out_h, out_w, 3]."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    oh, ow = out_hw
    out = np.empty((oh, ow, 3), np.float32)
    lib.rac_resize_crop_flip(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1], scale, crop_xy[0], crop_xy[1],
        int(flip), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        oh, ow, int(to_bgr),
    )
    return out


def radar_columns(uvdr: np.ndarray, hw: Tuple[int, int],
                  d_range=(1.0, 65.0)) -> Tuple[np.ndarray, np.ndarray]:
    """uvdr: [n, 4] projected (u, v, depth, rcs) -> (depth [h,w], rcs [h,w])."""
    lib = _load()
    assert lib is not None
    uvdr = np.ascontiguousarray(uvdr, np.float32)
    h, w = hw
    depth = np.empty((h, w), np.float32)
    rcs = np.empty((h, w), np.float32)
    lib.rac_radar_columns(
        uvdr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(uvdr),
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, d_range[0], d_range[1],
    )
    return depth, rcs
