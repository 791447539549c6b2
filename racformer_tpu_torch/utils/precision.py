"""The float32 precision of the port's entry points, pinned.

PyTorch runs float32 matrix products in full float32 by default but lets
cuDNN run float32 convolutions in TF32 (about three decimal digits). The
port's CPU goldens and `chip_smoke.py` hold full float32, so the drivers
turn TF32 off for both and say so, whatever the process's defaults were.
"""

from __future__ import annotations

import torch


def pin_float32_precision(log=print) -> None:
    """Turn TF32 off for float32 matmuls and cuDNN convolutions, and pass
    the line naming both flags to `log`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
