"""racformer_tpu_torch: the PyTorch / CUDA port of racformer_tpu for NVIDIA
Hopper (H100).

It runs the streaming eval step of the RaCFormer detector (encode the
newest frame, shift the 8-frame feature ring buffer, decode the window with
the weight-shared polar decoder, decode boxes without NMS) and its training
step (`train/`: augmentation, the train-mode forward with query denoising,
Hungarian matching, the losses, gradient accumulation, AdamW;
`python -m racformer_tpu_torch.train`). Each Pallas kernel of the JAX
package is a hand-written CUDA kernel (`csrc/`): the eval path's fused fold
gather K1, and the training samplers' patch gather K2, scatter-add backward
K3 and corner re-gather K4, bound in `ops/gather_kernel.py` and
`ops/scatter_kernel.py`; everything else is plain PyTorch. `racformer_tpu`
(JAX) stays the reference the port is tested against.

Layouts at public function boundaries are the JAX package's channel-last
ones; parameter names are the reference checkpoint's state-dict keys.
"""

__version__ = "0.1.0"
