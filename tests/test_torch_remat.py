"""The decoder's remat policies (`nn.decoder.REMAT_POLICIES`, the JAX
package's five of `racformer_tpu/nn/decoder.py`): each gives the gradients
of "full" bit for bit (they choose only what the backward recomputes), and
runs the sampler's forward (K2's plain version here) as often as the
policy says: every site twice under "full", "dots" and "dots_no_batch"
(the forward and the checkpointed recompute), once under "save_sampled",
and the image site twice, the BEV sites once, under "save_bev". At the
tiny f32 config of `tests/torch_distributed_workers.py` (2 decoder layers,
batch 2 in 2 microbatches, dropout on).
"""

import pytest
import torch

from racformer_tpu_torch.model import RaCFormer, random_init_
from racformer_tpu_torch.nn import decoder as port_decoder
from racformer_tpu_torch.ops import gather_kernel
from racformer_tpu_torch.train import Optimizer
from racformer_tpu_torch.train import step as step_mod

from tests import torch_distributed_workers as workers

LAYERS, MICRO, SITES = 2, 2, 3
# forward K2 launches per step: sites x iterations x microbatches; the
# recompute adds the sites a policy does not keep
FORWARD = SITES * LAYERS * MICRO
WANT = {"full": 2 * FORWARD, "dots": 2 * FORWARD,
        "dots_no_batch": 2 * FORWARD, "save_sampled": FORWARD,
        "save_bev": FORWARD + LAYERS * MICRO}


def step_with(policy, monkeypatch, **model_kw):
    """One train step under `policy` (the model's arguments `model_kw`
    over the workers' tiny config): (metrics, gradients, K2 calls)."""
    kw = dict(workers.KW, decoder=dict(workers.KW["decoder"],
                                       remat_policy=policy), **model_kw)
    model = random_init_(RaCFormer(**kw), torch.Generator().manual_seed(2))
    assert model.pts_bbox_head.transformer.decoder.remat_policy == policy
    opt = Optimizer(model.named_parameters(), base_lr=0.0)
    batch = workers.global_batch(3, 2)
    gen = torch.Generator().manual_seed(4)
    draws = [step_mod.make_draws(model, m, gen)
             for m in step_mod.split_microbatches(batch, MICRO)]
    calls = []
    plain = gather_kernel.patch_gather_reference
    monkeypatch.setattr(gather_kernel, "patch_gather_reference",
                        lambda *a: (calls.append(1), plain(*a))[1])
    metrics = step_mod.make_train_step(model, opt, workers.DEPTH, MICRO)(
        batch, draws=draws)
    return (metrics, {n: p.grad for n, p in model.named_parameters()},
            len(calls))


@pytest.fixture(scope="module")
def full():
    with pytest.MonkeyPatch.context() as mp:
        return step_with("full", mp)


@pytest.mark.parametrize("policy", sorted(port_decoder.REMAT_POLICIES))
def test_policy_gives_full_gradients_and_its_k2_count(policy, full,
                                                      monkeypatch):
    metrics, grads, k2 = step_with(policy, monkeypatch)
    assert k2 == WANT[policy]
    for k, v in full[0].items():
        assert torch.equal(metrics[k], v), k
    for n, g in full[1].items():
        assert torch.equal(grads[n], g), n


def test_environment_chooses_the_policy(monkeypatch):
    """The config's policy, else RACFORMER_REMAT_POLICY, else "full"."""
    monkeypatch.setenv("RACFORMER_REMAT_POLICY", "save_bev")
    assert port_decoder.resolve_remat_policy(None) == "save_bev"
    assert port_decoder.resolve_remat_policy("dots") == "dots"
    monkeypatch.delenv("RACFORMER_REMAT_POLICY")
    assert port_decoder.resolve_remat_policy(None) == "full"
    with pytest.raises(ValueError, match="unknown decoder remat_policy"):
        port_decoder.resolve_remat_policy("nope")
