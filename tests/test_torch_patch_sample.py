"""The training path's sampler of the PyTorch port against the JAX package:
`ops.bilinear.patch_sample_op` (kernels K2 forward, K3 and K4 backward) against
the JAX custom VJP `_patch_sample_pallas` (whose Pallas kernels run in
interpret mode here), reached through `bilinear_sample_views_nhwc`, so the
coordinate handling (floor, clamp, shift, lerp weights rounded to the map
dtype) is compared too. `tests/test_torch_sampling_sites.py` compares the
two sampling sites built on it.

On the CPU the port's wrappers take their plain versions. The inputs hold
points far outside the map, on its border and on integer pixels, and K
spans several of the JAX kernels' chunks. embed width 64 per map (2C = 128),
the only width at which the JAX custom VJP is taken.

Tolerances, relative to each tensor's max |value|: float32 1e-5 (the same
arithmetic summed in another order); bfloat16 2e-2 (the JAX forward rounds
its x-lerp to bf16 before the y-mix, the port rounds once; the map
gradients pass through bf16 additions in both); float16 2.5e-3, bfloat16's
scaled by the two types' epsilons (2^-10 / 2^-7): the same roundings one
float16 step wide. In float16 both packages still round the map
gradient's cotangent terms to bf16 before their f32 sums (the JAX custom
VJP's `.astype(jnp.bfloat16)`), then cast the sum to float16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.ops import bilinear as jbil

from racformer_tpu_torch.ops import scatter_kernel
from racformer_tpu_torch.ops.bilinear import (PAD, corner_coords, patch_sample,
                                              sampler_ready)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
          "float16": (jnp.float16, torch.float16, 2.5e-3)}


def close(got, want, tol, name):
    """got within tol of want's max |value|; prints the deviation
    relative to it (`-s`)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = tol * max(np.abs(want).max(), 1e-6)
    dev = np.abs(got - want).max() * tol / bound
    print(f"{name}: largest deviation {dev:.3g} of the largest |value| "
          f"(tolerance {tol:g})")
    np.testing.assert_allclose(got, want, rtol=tol, atol=bound, err_msg=name)


def _pixels(rng, shape, extent):
    """Pixel coordinates on an axis of `extent` pixels: most in the map or
    near its edge, 10% far outside, some on integer pixels and on the
    border (-1, -0.5, extent - 1, extent)."""
    x = rng.uniform(-2.5, extent + 1.5, size=shape)
    far = rng.uniform(size=shape) < 0.1
    x[far] = rng.choice([-400.0, -9.0, extent + 7.0, 3000.0], size=int(far.sum()))
    edge = [-1.0, -0.5, extent - 1.0, float(extent)][:shape[-1]]
    x[..., :len(edge)] = edge
    x[..., 4:10] = np.round(x[..., 4:10])
    return x.astype(np.float32)


def _outside(rng, shape, extent):
    """Pixel coordinates off the map on both sides, near and far, the
    first four exactly on the -1 edge: every sample reads only the zero
    border (an edge point weights its in-map corner by 0), and the edge
    points still carry location gradients."""
    x = np.where(rng.uniform(size=shape) < 0.5, rng.uniform(-3.0, -1.0, shape),
                 rng.uniform(extent, extent + 2.0, shape))
    far = rng.uniform(size=shape) < 0.1
    x[far] = rng.choice([-400.0, extent + 7.0], size=int(far.sum()))
    x[..., :4] = -1.0
    return x.astype(np.float32)


def _layout(rng, layout, S, J, K, H, W):
    """(view, x, y) of K points per slab. mixed: uniform views, points in
    the map, on its border, on integer pixels and far outside; outside:
    every point off the map in x; clustered: every point of a slab in one
    fused row (view 0, y in [4, 5)) and three columns."""
    if layout == "clustered":
        view = np.repeat(np.arange(S)[:, None] * J, K, axis=1)
        x = rng.integers(3, 6, (S, K)) + rng.uniform(size=(S, K))
        y = rng.uniform(4.0, 5.0, (S, K))
        return view.astype(np.int32), x.astype(np.float32), y.astype(np.float32)
    view = np.arange(S)[:, None] * J + rng.integers(0, J, (S, K))
    x = (_outside if layout == "outside" else _pixels)(rng, (S, K), W)
    return view.astype(np.int32), x, _pixels(rng, (S, K), H)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,layout", [
    pytest.param(37, "mixed", id="37"), pytest.param(5000, "mixed", id="5000"),
    pytest.param(1, "mixed", id="1"),
    pytest.param(300, "outside", id="300-outside"),
    pytest.param(2000, "clustered", id="2000-clustered")])
def test_patch_sample_matches_jax_custom_vjp(dtype, K, layout, monkeypatch):
    """Forward and the gradients for the map, x and y (through wx / wy)
    against `bilinear_sample_views_nhwc` on the JAX custom-VJP path with the
    Pallas forward; K=5000 spans two gather chunks and five scatter chunks
    of the JAX kernels, K=1 is one point per slab. The outside layout samples
    only the zero border; the clustered one puts a slab's 2000 points into
    one fused row, the hot row the gather kernels read from L2 and K3 cuts
    over several tiles. K3 returns the map gradient in the map's dtype."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(K)
    S, J, H, W, C = 2, 2, 9, 21, 64
    feat = rng.normal(size=(S * J, H, W, C)).astype(np.float32)
    view, x, y = _layout(rng, layout, S, J, K, H, W)
    g = rng.normal(size=(S, K, C)).astype(np.float32)

    def jax_fn(f, xx, yy):
        out = jbil.bilinear_sample_views_nhwc(
            f.astype(jdt), jnp.asarray(view), xx, yy, custom_grad=True,
            blocked_views=True, pallas_forward=True, batch_local=False)
        return out.astype(jnp.float32)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(feat), jnp.asarray(x), jnp.asarray(y))
    want_grads = vjp(jnp.asarray(g))

    ft, xt, yt = (torch.tensor(a, requires_grad=True) for a in (feat, x, y))
    fused = sampler_ready(ft.to(tdt))  # [S*J, R0, Wp, 2C]
    R0 = fused.shape[1]
    fused = fused.reshape(S, J * R0, *fused.shape[2:])
    x0p, y0p, wx, wy = corner_coords(xt, yt, H, W, tdt)
    row = torch.from_numpy(view % J) * R0 + y0p
    scattered = []
    scatter = scatter_kernel.patch_scatter
    monkeypatch.setattr(scatter_kernel, "patch_scatter",
                        lambda *a: scattered.append(scatter(*a)) or scattered[-1])
    got = patch_sample(fused, row, x0p, wx, wy).float()
    got.backward(torch.from_numpy(g))
    assert [d.dtype for d in scattered] == [fused.dtype]
    close(got.detach(), want, tol, "out")
    for t, w, n in zip((ft, xt, yt), want_grads, ("d_feat", "d_x", "d_y")):
        close(t.grad, w, tol, n)
    if layout == "outside":
        assert not got.detach().abs().max() and not np.abs(np.asarray(want)).max()
    if layout != "clustered" and K >= 4:
        # the border points sample zeros but still carry location gradients
        assert np.abs(np.asarray(want_grads[1])[:, :4]).max() > 0


def test_patch_sample_integer_inputs_get_no_gradient():
    fused = torch.randn(1, 6, 8, 128, requires_grad=True)
    row = torch.tensor([[0, 3, 4]], dtype=torch.int32)
    x0p = torch.tensor([[0, 2, 6]], dtype=torch.int32)
    wx = torch.rand(1, 3, requires_grad=True)
    wy = torch.rand(1, 3, requires_grad=True)
    out = patch_sample(fused, row, x0p, wx, wy)
    assert out.shape == (1, 3, 64)
    grads = torch.autograd.grad(out.sum(), (fused, wx, wy))
    assert all(gr is not None and gr.abs().sum() > 0 for gr in grads)
    assert not row.requires_grad and not x0p.requires_grad


@pytest.mark.parametrize("S,R,K", [(3, 7, 50), (2, 40, 1), (1, 5, 333),
                                     (2, 1, 64), (2, 9, 1025)])
def test_bucket_by_row_contract(S, R, K):
    """The bucketing K3 relies on: every point appears once, in the bucket
    of its key s * R + row, and the offsets are the cumulative row counts
    (empty rows included); each record carries its point's x0p and row, wx,
    wy."""
    rng = np.random.default_rng(S * 100 + K)
    row_np = rng.integers(0, R, size=(S, K))
    row_np[:, : K // 2] = R // 2  # a hot row beside empty ones
    x0p = torch.from_numpy(rng.integers(0, 9, size=(S, K))).to(torch.int32)
    wx, wy = (torch.from_numpy(rng.uniform(size=(S, K)).astype(np.float32))
              for _ in range(2))
    offsets, records = scatter_kernel.bucket_by_row(
        torch.from_numpy(row_np).to(torch.int32), x0p, wx, wy, R)
    assert offsets.dtype == records.dtype == torch.int32
    key = (np.arange(S)[:, None] * R + row_np).reshape(-1)
    want = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=S * R))])
    np.testing.assert_array_equal(offsets.numpy(), want)
    perm = records[:, 0].numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(S * K))
    bucket = np.repeat(np.arange(S * R), np.diff(want))
    np.testing.assert_array_equal(key[perm], bucket)
    np.testing.assert_array_equal(records[:, 1].numpy(), x0p.numpy().reshape(-1)[perm]
                                  + (row_np.reshape(-1)[perm] << 16))
    for col, w in ((2, wx), (3, wy)):
        np.testing.assert_array_equal(records[:, col].view(torch.float32).numpy(),
                                      w.numpy().reshape(-1)[perm])


def test_corner_coords_clamp_into_the_border():
    """floor, clamp to [-PAD, W], shift by PAD; far points land wholly in
    the zero border."""
    x = torch.tensor([-1e4, -2.5, -0.25, 0.0, 3.75, 9.0, 10.0, 1e4])
    x0p, _, wx, _ = corner_coords(x, x, 10, 10, torch.float32)
    assert x0p.tolist() == [0, 0, 1, 2, 5, 11, 12, 12]
    assert x0p.max().item() + 1 <= 10 + 2 * PAD - 1
    torch.testing.assert_close(wx, x - torch.floor(x))
