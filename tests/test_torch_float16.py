"""float16 maps through the port against the JAX package on the CPU.

Every dtype a config may name (`model.racformer.DTYPES`: `trunk_dtype`,
`head_dtype`, `decoder.gather_dtype`) has a kernel code, so the card's
kernels K1-K4 take every map dtype the config lets through. The JAX drivers
pass the config's strings to flax, so float16 is the JAX package's too.

The whole model at `tests/test_torch_slice.py`'s tiny config (2 cameras, 2
frames, embed_dims 256, 12 queries, 2 decoder layers) with
`trunk_dtype = gather_dtype = float16` on both sides, the port's seeded
random weights converted into the JAX model (`test_torch_golden.py`'s
`golden_pair` pattern), one seeded ring-camera batch. The port samples
through K1's plain version; the JAX side takes its CPU default, the XLA
sampler (its fold kernel in interpret mode costs ~25 s more to compile;
`tests/test_torch_gather_fold.py` holds K1's plain version against that
kernel). The outputs come out float32 and finite. Tolerance: each of the
class scores, the boxes and the depth logits within 2^-8 of max(1,
max|JAX|), four float16 steps at 1 (measured, printed with `-s`: 1.29e-3 of
6.87, 9.3e-4 of 44.4 and 2.1e-3 of 1.22; with its fold kernel JAX's own float16 outputs lie
9.6e-4, 7.9e-4 and 2.0e-3 from its float32 ones, so the two packages round
the trunk's float16 at other places, by about the size of float16's own
effect).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess
from racformer_tpu.tools.convert_weights import convert_state_dict

from racformer_tpu_torch.model import (RaCFormer, config_kwargs,
                                       preprocess_images, random_init_)
from racformer_tpu_torch.model.racformer import DTYPES
from racformer_tpu_torch.ops import gather_kernel
from tests.test_torch_slice import ARG_KEYS, TINY, ring_batch

TOL = 2.0**-8


def test_every_config_dtype_has_a_kernel_code():
    """`config_kwargs` takes each of `DTYPES` for the three dtype fields,
    and each has a code in `gather_kernel._DTYPE_CODES`, which K1-K4's
    entry points dispatch on: no dtype a config names is refused at the
    first launch on the card."""
    for name, dtype in DTYPES.items():
        kwargs = config_kwargs({"model": {"trunk_dtype": name,
                                          "head_dtype": name,
                                          "decoder": {"gather_dtype": name}}})
        assert (kwargs["trunk_dtype"], kwargs["head_dtype"],
                kwargs["decoder"]["gather_dtype"]) == (dtype,) * 3
        assert gather_kernel.dtype_code("test", dtype) == \
            gather_kernel._DTYPE_CODES[dtype]
    assert set(gather_kernel._DTYPE_CODES) == set(DTYPES.values())
    assert len(set(gather_kernel._DTYPE_CODES.values())) == len(DTYPES)


def test_float16_maps_match_jax():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batch = ring_batch(0)
        model = RaCFormer(**TINY, trunk_dtype=torch.float16,
                          decoder={"gather_dtype": torch.float16})
        random_init_(model, torch.Generator().manual_seed(0)).eval()
        jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float16,
                              decoder={"gather_dtype": jnp.float16},
                              fused_gather=None, train_mode=False)
        jargs = [jax_preprocess(jnp.asarray(batch["imgs"]))] + [
            jnp.asarray(batch[k]) for k in ARG_KEYS]
        template = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *jargs))
        variables, unmatched = convert_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, template,
            strict=True)
        assert unmatched == []
        want = jax.jit(jmodel.apply)(variables, *jargs)
        t = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()}
        sampled = []
        sampler = model.pts_bbox_head.transformer.decoder.decoder_layer.sampling
        hook = sampler.register_forward_hook(
            lambda m, i, o: sampled.append(o))
        with torch.no_grad():
            got = model(preprocess_images(t["imgs"]), *[t[k] for k in ARG_KEYS])
        hook.remove()
    finally:
        torch.set_num_threads(threads)
    # the image sampler reads the float16 pyramid, not only its zero border
    assert all(s.dtype == torch.float16 and (s != 0).float().mean() > 0.2
               for s in sampled)
    for key in ("all_cls_scores", "all_bbox_preds", "depth_logits"):
        port, ref = got[key], np.asarray(want[key], np.float32)
        assert port.dtype == torch.float32 and bool(torch.isfinite(port).all())
        dev = float(np.abs(port.numpy() - ref).max())
        bound = TOL * max(1.0, float(np.abs(ref).max()))
        print(f"float16 {key}: largest deviation {dev:.4g} (largest |JAX| "
              f"{np.abs(ref).max():.4g}, bound {bound:.4g})")
        assert dev <= bound, f"{key}: largest deviation {dev:.4g} > {bound:.4g}"
