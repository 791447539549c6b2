"""The benchmark's plain reference: a frozen copy of the port's plain path
(`racformer_tpu_torch`'s model, samplers, box decode and train step, with
the plain versions of K1-K4 in place of the kernels). It imports neither
JAX, nor the JAX package, nor the port: later changes to the port cannot
move it. `streaming.py` rebuilds a stream's window from its frames."""
