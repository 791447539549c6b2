"""Sampling, box and geometry ops of the port (plain PyTorch, plus the CUDA
fold gather in `gather_kernel`)."""
