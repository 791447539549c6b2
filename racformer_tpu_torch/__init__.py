"""racformer_tpu_torch: the PyTorch / CUDA port of racformer_tpu for NVIDIA
Hopper (H100).

It runs the streaming eval step of the RaCFormer detector: encode the newest
frame, shift the 8-frame feature ring buffer, decode the window with the
weight-shared polar decoder, and decode boxes without NMS. The one Pallas
kernel on that path, the fused fold gather, is a hand-written CUDA kernel
(`csrc/gather_fold.cu`, bound in `ops/gather_kernel.py`); everything else is
plain PyTorch. `racformer_tpu` (JAX) stays the reference the port is tested
against.

Layouts at public function boundaries are the JAX package's channel-last
ones; parameter names are the reference checkpoint's state-dict keys.
"""

__version__ = "0.1.0"
