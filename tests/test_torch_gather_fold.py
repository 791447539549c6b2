"""Kernel K1 (the fused fold gather) of the PyTorch port against the JAX
package's Pallas kernel, which runs in interpret mode here.

On the CPU the port's wrapper takes the plain PyTorch version, so these
tests pin its arithmetic and both call sites' coordinate mappings: the image
site (`msmv_sample_fold`, `x * (W - 1)`, level-interleaved points over the
level-concatenated map) and the BEV site (`deform_attn_single_level` with
`fold_points`, `x * W - 0.5`, head rows, a sum over the remaining points).
The inputs include points far outside the map, integer coordinates and
fold = 1. float32 throughout; tolerance 1e-5 (the two sum in another order).
The CUDA kernel itself is checked on the card by `tests/test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.ops import bilinear as jbil
from racformer_tpu.ops.deform_attn import deform_attn_single_level as jax_deform
from racformer_tpu.ops.gather_kernel import patch_sample_fold as jax_fold
from racformer_tpu.ops.msmv import msmv_sample_fold as jax_msmv_fold

from racformer_tpu_torch.ops import gather_kernel
from racformer_tpu_torch.ops.bilinear import sampler_ready
from racformer_tpu_torch.ops.deform_attn import deform_attn_single_level
from racformer_tpu_torch.ops.msmv import msmv_sample_fold
from racformer_tpu_torch.nn.img_sampling import concat_geometry

TOL = dict(rtol=1e-5, atol=1e-5)


def _coords(rng, shape, extent):
    """Normalized coordinates: most in the map, ~20% far outside it."""
    x = rng.uniform(-0.05, 1.05, size=shape)
    far = rng.uniform(size=shape) < 0.2
    x[far] = rng.choice([-3.0, -0.6, 1.7, 4.0], size=int(far.sum()))
    # exact integer pixel positions for a slice of the points
    x[..., :2] = np.round(x[..., :2] * extent) / extent
    return x.astype(np.float32)


def _jax_cat(levels, hws):
    """The JAX package's level-concatenated map (W-aligned levels)."""
    fused = [jbil.fuse_rows(jbil.pad_for_sampling(jnp.asarray(f), align=True))
             for f in levels]
    wmax = max(f.shape[-2] for f in fused)
    fused = [jnp.pad(f, [(0, 0)] * (f.ndim - 2) + [(0, wmax - f.shape[-2]),
                                                   (0, 0)]) for f in fused]
    return jnp.concatenate(fused, axis=-3)


def test_image_site_matches_jax():
    rng = np.random.default_rng(0)
    S, N, Q, P, C = 2, 2, 8, 12, 64
    image_hw = (64, 128)
    hws, roffs, rcat = concat_geometry(image_hw, 4)
    levels = [rng.normal(size=(S, N, h, w, C)).astype(np.float32)
              for h, w in hws]
    x = _coords(rng, (S, Q, P), hws[0][1] - 1)
    y = _coords(rng, (S, Q, P), hws[0][0] - 1)
    view = rng.integers(0, N, size=(S, Q, P)).astype(np.int32)
    w = rng.dirichlet(np.ones(4), size=(S, Q, P)).astype(np.float32)

    want = jax_msmv_fold(_jax_cat(levels, hws), jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(view), jnp.asarray(w), hws, roffs, rcat,
                         batch_local=False)
    port_levels = [sampler_ready(torch.from_numpy(f)) for f in levels]
    wmax = max(f.shape[-2] for f in port_levels)
    cat = torch.cat([torch.nn.functional.pad(f, (0, 0, 0, wmax - f.shape[-2]))
                     for f in port_levels], dim=-3)
    got = msmv_sample_fold(cat, torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(view), torch.from_numpy(w), hws,
                           roffs, rcat)
    assert got.shape == (S, Q, P, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.abs().sum(-1) == 0).any() and (got.abs().sum(-1) > 0).any()


def test_bev_site_matches_jax():
    rng = np.random.default_rng(1)
    S, M, H, W, c, Q, P = 2, 4, 16, 16, 64, 8, 20
    value = rng.normal(size=(S, M, H, W, c)).astype(np.float32)
    x = _coords(rng, (S, Q, M, P), W)
    y = _coords(rng, (S, Q, M, P), H)
    w = rng.dirichlet(np.ones(P), size=(S, Q, M)).astype(np.float32)

    fused = jbil.fuse_rows(jbil.pad_for_sampling(jnp.asarray(value), align=True))
    want = jax_deform(fused, None, jnp.asarray(w), loc_xy=(jnp.asarray(x),
                      jnp.asarray(y)), pre_fused=True, true_hw=(H, W),
                      fold_points=4)
    got = deform_attn_single_level(
        sampler_ready(torch.from_numpy(value)), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(w), (H, W), 4)
    assert got.shape == (S, Q, M * c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fold,layout", [
    (1, "uniform"), (2, "uniform"), (4, "uniform"), (8, "uniform"),
    (4, "border"), (4, "clustered")])
def test_kernel_contract_matches_jax(fold, layout):
    """K1 on explicit per-point inputs, corners included: column 0, the last
    readable column and exact integer positions (wx = wy = 0); folds that
    divide the JAX kernel's group of 256 points (it drops tail points
    otherwise); every point on the zero border (both results exactly zero);
    90% of the points in one row of ten."""
    rng = np.random.default_rng(2 + fold + 10 * (layout != "uniform"))
    S, R, W, C, K = 2, 10, 13, 64, 64
    Wp = jbil.aligned_width(W - 2 * jbil.PAD)  # the TPU kernel's stored width
    fused = rng.normal(size=(S, R, Wp, 2 * C)).astype(np.float32)
    row = rng.integers(0, R, size=(S, K)).astype(np.int32)
    x0p = rng.integers(0, W - 1, size=(S, K)).astype(np.int32)
    x0p[:, 0], x0p[:, 1] = 0, W - 2
    wx = rng.uniform(size=(S, K)).astype(np.float32)
    wy = rng.uniform(size=(S, K)).astype(np.float32)
    wx[:, :8:2] = 0.0
    wy[:, :8:2] = 0.0
    wl = rng.normal(size=(S, K)).astype(np.float32)
    if layout == "border":  # columns 0-1 and W-2.. are the zero border
        fused[:, :, :jbil.PAD] = 0.0
        fused[:, :, W - jbil.PAD:] = 0.0
        x0p[:] = np.where(np.arange(K) % 2 == 0, 0, W - 2)
    elif layout == "clustered":
        hot = rng.integers(0, R, size=(S, 1))
        row = np.where(rng.uniform(size=(S, K)) < 0.9, hot, row).astype(np.int32)
    want = jax_fold(jnp.asarray(fused), jnp.asarray(row), jnp.asarray(x0p),
                    jnp.asarray(wx), jnp.asarray(wy), jnp.asarray(wl), fold,
                    batch_local=False)
    args = [torch.from_numpy(a) for a in (fused, row, x0p, wx, wy, wl)]
    got = gather_kernel.patch_sample_fold(*args, fold)
    assert got.shape == (S, K // fold, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if layout == "border":
        assert not got.any() and not np.asarray(want).any()


def test_wrapper_checks_shapes():
    fused = torch.zeros(2, 4, 8, 128)
    row = torch.zeros(2, 6, dtype=torch.int32)
    f = torch.zeros(2, 6)
    with pytest.raises(ValueError):
        gather_kernel.patch_sample_fold(fused, row, row, f, f, f, 4)
    with pytest.raises(ValueError):
        gather_kernel.patch_sample_fold(fused, row, row[:, :4], f, f, f, 2)
    before = gather_kernel.LAUNCHES
    gather_kernel.patch_sample_fold(fused, row, row, f, f, f, 3)
    assert gather_kernel.LAUNCHES == before  # the plain version launches nothing
