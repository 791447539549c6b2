"""The train loss's Hungarian matching on the card (`csrc/lap_assign.cu`,
through `train.matching.hungarian_assign`).

On the CPU: a CPU cost takes the host solver `assign_host` and the open
span counts `host_assigns`; the wrapper refuses a cost that is not float32,
not contiguous or wider than tall (G > Q) before it launches anything, and
hands the kernel the problem count, Q, G and the stream (its launch stood in
for); the loss's `train.matching` span counts every problem it solves.
On a card (`cuda` marker): the kernel's matches equal `assign_host`'s bit
for bit on padded flagship costs (1, 5, 32 and 64 valid rows of 64, B = 1
and 2), on small integer costs full of ties, on square problems (G = Q) and
on the cartesian cost; `detection_loss` with the kernel equals
`detection_loss` under `force_reference()` in every loss, bit for bit, and
in its match statistics; without `with_match` it neither waits for the
device nor copies between host and device. No JAX, so on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_lap_kernel.py
"""

import numpy as np
import pytest
import torch

from racformer_tpu_torch.ops import gather_kernel
from racformer_tpu_torch.train import losses, matching
from racformer_tpu_torch.utils import tracing

L, Q, G = 6, 900, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def gt(rng, valid, g=G):
    """Raw GT boxes [B, g, 9], labels [B, g] and the mask of the first
    valid[b] rows of sample b."""
    B = len(valid)
    boxes = np.zeros((B, g, 9), np.float32)
    boxes[..., :3] = rng.uniform(-50, 50, (B, g, 3))
    boxes[..., 3:6] = rng.uniform(0.5, 5.0, (B, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, g))
    boxes[..., 7:9] = rng.normal(size=(B, g, 2))
    labels = rng.integers(0, 10, (B, g))
    mask = np.arange(g)[None] < np.asarray(valid)[:, None]
    return boxes, labels, mask


def outs(rng, B, q=Q, layers=L, dn_groups=0, g=G):
    """Head outputs as `detection_loss` takes them (numpy)."""
    out = {"all_cls_scores": rng.normal(size=(layers, B, q, 10)).astype(np.float32),
           "all_bbox_preds": rng.normal(size=(layers, B, q, 10)).astype(np.float32) * 2}
    if dn_groups:
        out["dn_cls_scores"] = rng.normal(
            size=(layers, B, dn_groups * g, 10)).astype(np.float32)
        out["dn_bbox_preds"] = rng.normal(
            size=(layers, B, dn_groups * g, 10)).astype(np.float32)
    return out


def flagship_cost(valid, dev, seed=0, cartesian=False):
    """The loss's cost [L, B, Q, G] on `dev` for samples with `valid` GT
    rows each, from random head outputs (padded rows cost BIG)."""
    rng = np.random.default_rng(seed)
    boxes, labels, mask = gt(rng, valid)
    o = outs(rng, len(valid))
    fn = matching.match_cost_cartesian if cartesian else matching.match_cost
    t = lambda a: torch.as_tensor(a, device=dev)
    return fn(t(o["all_cls_scores"]), t(o["all_bbox_preds"]), t(boxes)[None],
              t(labels)[None], t(mask)[None], losses.CODE_WEIGHTS)


# --- CPU ---------------------------------------------------------------------

def test_cpu_costs_take_the_host_solver_and_count_it():
    cost = flagship_cost([5, 64], "cpu")
    launches = matching.LAP_LAUNCHES
    tracing.enable()
    with tracing.span("outer"):
        got = matching.hungarian_assign(cost)
    assert matching.LAP_LAUNCHES == launches
    assert tracing.records()[0].counts == {"host_assigns": L * 2}
    assert got.dtype == torch.int64 and got.shape == (L, 2, G)
    np.testing.assert_array_equal(got.numpy(),
                                  matching.assign_host(cost.numpy()))


@pytest.fixture
def fake_launch(monkeypatch):
    """The CUDA route on CPU tensors: `launch` recorded, not called."""
    calls = []
    monkeypatch.setattr(gather_kernel, "use_reference", lambda t: False)
    monkeypatch.setattr(gather_kernel, "current_stream", lambda t: 7)
    monkeypatch.setattr(gather_kernel, "launch", lambda *a: calls.append(a))
    return calls


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "strided", "wide", "flat"])
def test_wrapper_refuses_a_bad_cost_before_launching(fake_launch, bad):
    cost = torch.rand(2, 30, 12)
    cost = {"float64": cost.double(), "bfloat16": cost.bfloat16(),
            "strided": cost[:, ::2], "wide": torch.rand(2, 10, 12),
            "flat": torch.rand(30)}[bad]
    launches = matching.LAP_LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        matching.hungarian_assign(cost)
    assert fake_launch == [] and matching.LAP_LAUNCHES == launches


def test_wrapper_hands_the_kernel_its_problem(fake_launch):
    cost = torch.rand(3, 2, 30, 12)
    launches = matching.LAP_LAUNCHES
    tracing.enable()
    with tracing.span("outer"):
        got = matching.hungarian_assign(cost)
    (name, c, scratch, out, problems, q, g, stream), = fake_launch
    assert (name, c, out, problems, q, g, stream) == (
        "lap_assign", cost.data_ptr(), got.data_ptr(), 6, 30, 12, 7)
    assert scratch != c and scratch != out
    assert got.shape == (3, 2, 12) and got.dtype == torch.int64
    assert matching.LAP_LAUNCHES == launches + 1
    assert tracing.records()[0].counts == {"device_assigns": 6}


def test_loss_span_counts_every_problem():
    rng = np.random.default_rng(1)
    boxes, labels, mask = gt(rng, [3, 7], g=8)
    o = {k: torch.as_tensor(v) for k, v in outs(rng, 2, q=20, layers=3).items()}
    tracing.enable()
    losses.detection_loss(o, torch.as_tensor(boxes), torch.as_tensor(labels),
                          torch.as_tensor(mask))
    spans = [r for r in tracing.records() if r.name == "train.matching"]
    assert [r.counts for r in spans] == [{"gt_rows": 3 * 2 * 8,
                                          "host_assigns": 3 * 2}]


# --- on the card -------------------------------------------------------------

def assert_kernel_equals_host(cost):
    launches = matching.LAP_LAUNCHES
    got = matching.hungarian_assign(cost)
    torch.cuda.synchronize()
    assert matching.LAP_LAUNCHES == launches + 1
    want = matching.assign_host(cost.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert got.dtype == torch.int64 and got.device == cost.device


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [[1], [5], [32], [64], [1, 33], [64, 5]])
def test_kernel_equals_host_on_padded_flagship_costs(cuda, valid):
    assert_kernel_equals_host(flagship_cost(valid, cuda, seed=len(valid) * 100
                                            + valid[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("levels,q,g", [(2, 30, 12), (3, 200, 64), (5, 900, 64),
                                         (4, 2100, 40), (3, 5000, 16)])
def test_kernel_equals_host_on_ties(cuda, levels, q, g):
    rng = np.random.default_rng(levels)
    cost = rng.integers(0, levels, (4, q, g)).astype(np.float32)
    assert_kernel_equals_host(torch.as_tensor(cost, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 64, 300])
def test_kernel_equals_host_when_square(cuda, n):
    rng = np.random.default_rng(n)
    cost = rng.normal(size=(3, n, n)).astype(np.float32)
    cost[1] = np.round(cost[1])  # ties
    assert_kernel_equals_host(torch.as_tensor(cost, device=cuda))


@pytest.mark.cuda
def test_kernel_equals_host_on_the_cartesian_cost(cuda):
    assert_kernel_equals_host(flagship_cost([5, 40], cuda, seed=3,
                                            cartesian=True))


def loss_inputs(dev, valid, seed):
    rng = np.random.default_rng(seed)
    boxes, labels, mask = gt(rng, valid)
    o = outs(rng, len(valid), dn_groups=2)
    o["dn_valid"] = np.tile(mask, (1, 2))
    t = lambda a: torch.as_tensor(a, device=dev)
    return {k: t(v) for k, v in o.items()}, t(boxes), t(labels), t(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [[5], [3, 64]])
def test_detection_loss_equals_its_host_matched_version(cuda, valid):
    args = loss_inputs(cuda, valid, seed=sum(valid))
    launches = matching.LAP_LAUNCHES
    got = losses.detection_loss(*args, with_match=True)
    assert matching.LAP_LAUNCHES == launches + 1
    with gather_kernel.force_reference():
        want = losses.detection_loss(*args, with_match=True)
    assert matching.LAP_LAUNCHES == launches + 1
    assert set(got) == set(want)
    for k in want:
        if k.startswith("_"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_detection_loss_does_not_wait_for_the_device(cuda):
    from torch.profiler import ProfilerActivity, profile

    args = loss_inputs(cuda, [5, 64], seed=4)
    losses.detection_loss(*args)  # the constants and the library, made once
    torch.cuda.synchronize()
    tracing.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses.detection_loss(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = [r.counts for r in tracing.records() if r.name == "train.matching"]
    assert counts == [{"gt_rows": L * 2 * G, "device_assigns": L * 2}]
    copies = []
    for with_match in (False, True):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            losses.detection_loss(*args, with_match=with_match)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        copies.append(sum(n == "aten::_local_scalar_dense" or "HtoD" in n
                          or "DtoH" in n or "cudaStreamSynchronize" in n
                          for n in names))
    assert copies[0] == 0
    assert copies[1] > 0  # the match statistics copy: what the count sees
