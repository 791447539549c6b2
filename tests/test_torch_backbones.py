"""The port's VoVNet and BEV nets (`racformer_tpu_torch/nn/vovnet.py`,
`bev_nets.py`) against the JAX package's (`racformer_tpu/nn/vovnet.py`,
`bev_nets.py`), on weights carried across by `state_dict_from_jax`, in
float32 within 1e-4 of each output's largest value.

* VoVNet on a narrow spec with two blocks in every stage (registered in
  both packages' `SPECS` for the test: the real V-19 specs have one block
  a stage, so they never add the identity), at 64x64: the four stages'
  outputs; in train mode the checkpointed blocks give the same outputs
  and gradients as plain ones.
* Each of the five real specs: the output shapes at 64x64 and the number
  of parameters and BatchNorm statistics against `jax.eval_shape` of the
  JAX module (nothing compiled), and every state-dict key converted.
* `BEVResNet` and `FPNLSS` at `tests/test_backbones.py`'s sizes (a 32^2 BEV
  of 64 channels, out_channels 64): in eval mode (random running
  statistics) and in train mode (batch statistics, and the updated running
  statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.nn import vovnet as jvovnet
from racformer_tpu.nn.bev_nets import BEVResNet as JaxBEVResNet
from racformer_tpu.nn.bev_nets import FPNLSS as JaxFPNLSS

from racformer_tpu_torch.nn import vovnet
from racformer_tpu_torch.nn.bev_nets import BEVResNet, FPNLSS
from racformer_tpu_torch.tools.convert_weights import state_dict_from_jax

from tests.test_torch_slice import perturb

NARROW = dict(stem=(16, 16, 32), stage_conv=(16, 24, 32, 40),
              stage_out=(32, 48, 64, 80), layers=2, blocks=(2, 2, 2, 2))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=err_msg)


def ported(module, variables):
    module.load_state_dict(state_dict_from_jax(variables, module))
    return module


def test_vovnet_narrow_spec_matches_jax(monkeypatch):
    monkeypatch.setitem(jvovnet.SPECS, "narrow", NARROW)
    monkeypatch.setitem(vovnet.SPECS, "narrow", NARROW)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jvovnet.VoVNet(spec_name="narrow", remat=False, dtype=jnp.float32)
    variables = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    model = ported(vovnet.VoVNet("narrow", remat=False), variables).eval()
    got = model(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 16, 16, 32), (2, 8, 8, 48), (2, 4, 4, 64), (2, 2, 2, 80)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.abs(np.asarray(w)).max() > 0.1
        close(g, w, f"stage {i + 2}")
    # train mode: the checkpointed OSA blocks give the plain blocks' outputs
    # and gradients (the BatchNorm is frozen)
    remat = ported(vovnet.VoVNet("narrow", remat=True), variables).train()
    plain = ported(vovnet.VoVNet("narrow", remat=False), variables).train()
    for m in (remat, plain):
        sum(o.square().sum() for o in m(torch.from_numpy(x))).backward()
    for (name, a), (_, b) in zip(remat.named_parameters(),
                                 plain.named_parameters()):
        assert torch.equal(a.grad, b.grad), name


@pytest.mark.parametrize("spec", sorted(jvovnet.SPECS))
def test_vovnet_spec_shapes_and_parameters(spec):
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    jm = jvovnet.VoVNet(spec_name=spec, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    outs = jax.eval_shape(jm.apply, shapes, x)
    with torch.device("meta"):
        model = vovnet.VoVNet(spec)
        got = model(torch.empty(1, 64, 64, 3))
    assert [tuple(g.shape) for g in got] == [o.shape for o in outs]
    count = lambda tree: sum(int(np.prod(s.shape))
                             for s in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == count(shapes["params"])
    stats = sum(b.numel() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    assert stats == count(shapes["batch_stats"])
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    assert set(state_dict_from_jax(template, model)) == set(model.state_dict())


@pytest.mark.parametrize("train", [False, True])
def test_bev_resnet_and_fpnlss_match_jax(train):
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 64)).astype(np.float32)
    jr = JaxBEVResNet(dtype=jnp.float32)
    rv = perturb(jax.jit(jr.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    net = ported(BEVResNet(64), rv).train(train)
    jf = JaxFPNLSS(out_channels=64, dtype=jnp.float32)
    feats = jr.apply(rv, jnp.asarray(x))
    fv = perturb(jax.jit(jf.init)(jax.random.PRNGKey(1), feats), 3)
    neck = ported(FPNLSS(128 + 512, 64), fv).train(train)
    if train:
        (want, new_r) = jr.apply(rv, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        want_out, new_f = jf.apply(fv, want, train=True,
                                   mutable=["batch_stats"])
    else:
        want = jr.apply(rv, jnp.asarray(x))
        want_out = jf.apply(fv, want)
    got = net(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, f"BEVResNet stage {i}")
    out = neck(got)
    assert tuple(out.shape) == (2, 32, 32, 64)
    close(out, want_out, "FPNLSS")
    if train:
        for module, new in ((net, new_r), (neck, new_f)):
            want_sd = state_dict_from_jax({"params": {}, **new}, module,
                                          keys={k for k in module.state_dict()
                                                if k.endswith(("running_mean",
                                                               "running_var"))})
            for k, v in want_sd.items():
                close(module.state_dict()[k], v.numpy(), k)
