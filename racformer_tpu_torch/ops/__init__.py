"""Sampling, box and geometry ops of the port (plain PyTorch, plus the CUDA
fold gather in `gather_kernel`)."""

import functools

import torch


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """`torch.tensor(values)` on `device`, made once per values, device and
    dtype and shared by every caller (who must not write to it). Made per
    call, it would be a host-to-device copy that waits for the device and
    that a CUDA graph cannot capture."""
    return torch.tensor(values, dtype=dtype, device=device)
