"""`fused_gather=False`: the port's eval forward through the unfolded
samplers (K2's forward at every site, the counterpart of the JAX package's
per-level path) against the JAX package's `fused_gather=False` forward and
against the port's own folded forward (K1), as `tests/test_fused_gather.py`
holds the JAX package's two paths: within 2e-4, at
`tests/test_torch_slice.py`'s tiny config (embed_dims 256, 2 decoder
layers), float32 trunk and maps. The JAX side takes its plain CPU path;
the port its kernels' plain versions, whose calls are counted: with
`fused_gather=False` the fold gather (K1) is never called and the
per-point sampler once per site and decoder iteration, with the default
the other way round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.model import preprocess_images as jax_preprocess

from racformer_tpu_torch.model import RaCFormer, preprocess_images
from racformer_tpu_torch.ops import gather_kernel
from racformer_tpu_torch.tools.convert_weights import state_dict_from_jax

from tests.test_torch_slice import ARG_KEYS, TINY, perturb, ring_batch

SITES = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counted(fused, variables, batch, monkeypatch):
    """The port's eval forward with `fused_gather=fused`, and the calls of
    K1's and K2's plain versions it made."""
    model = RaCFormer(**TINY, trunk_dtype=torch.float32,
                      decoder={"gather_dtype": torch.float32},
                      fused_gather=fused)
    model.load_state_dict(state_dict_from_jax(variables, model))
    calls = {"K1": 0, "K2": 0}
    for name, key in (("patch_sample_fold_reference", "K1"),
                      ("patch_gather_reference", "K2")):
        plain = getattr(gather_kernel, name)

        def spy(*a, plain=plain, key=key):
            calls[key] += 1
            return plain(*a)

        monkeypatch.setattr(gather_kernel, name, spy)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out = model.eval()(preprocess_images(t["imgs"]), *[t[k] for k in ARG_KEYS])
    monkeypatch.undo()
    return {k: v.numpy() for k, v in out.items()}, calls


@pytest.fixture(scope="module")
def runs():
    batch = ring_batch(0)
    jmodel = JaxRaCFormer(**TINY, trunk_dtype=jnp.float32,
                          decoder={"gather_dtype": jnp.float32},
                          fused_gather=False, train_mode=False)
    jargs = [jax_preprocess(jnp.asarray(batch["imgs"]))] + [
        jnp.asarray(batch[k]) for k in ARG_KEYS]
    variables = perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jargs), 1)
    want = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.apply)(variables, *jargs))
    with pytest.MonkeyPatch.context() as mp:
        unfolded = _counted(False, variables, batch, mp)
        folded = _counted(None, variables, batch, mp)
    return want, unfolded, folded


def test_unfolded_path_calls_only_the_per_point_sampler(runs):
    _, (_, unfolded), (_, folded) = runs
    layers = TINY["num_decoder_layers"]
    assert unfolded == {"K1": 0, "K2": SITES * layers}
    assert folded == {"K1": SITES * layers, "K2": 0}


@pytest.mark.parametrize("key", ["all_cls_scores", "all_bbox_preds"])
def test_unfolded_path_matches_jax_and_the_fold(runs, key):
    want, (got, _), (fold, _) = runs
    np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[key], fold[key], rtol=2e-4, atol=2e-4)
