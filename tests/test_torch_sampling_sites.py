"""The two sampling sites of the port's training path against the JAX
package, with gradients: the image site (`ops.msmv.msmv_sample_levels` over
the level-concatenated map against the JAX per-level path
`msmv_sample_xyv(pallas=True)`) and the BEV site
(`ops.deform_attn.deform_attn_single_level(fold_points=0)` against
`deform_attn_single_level(pallas=True)`). Both run `patch_sample_op` (K2
forward, K3 / K4 backward; plain versions on the CPU) against the JAX
custom VJP with its Pallas kernels in interpret mode.

Tolerances as in `tests/test_torch_patch_sample.py`: relative to each
tensor's max |value|, float32 1e-5, bfloat16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.ops import bilinear as jbil
from racformer_tpu.ops.deform_attn import deform_attn_single_level as jax_deform
from racformer_tpu.ops.msmv import msmv_sample_xyv

from racformer_tpu_torch.nn.img_sampling import concat_geometry
from racformer_tpu_torch.ops.bilinear import sampler_ready
from racformer_tpu_torch.ops.deform_attn import deform_attn_single_level
from racformer_tpu_torch.ops.msmv import level_concat, msmv_sample_levels

from tests.test_torch_patch_sample import DTYPES, _pixels, close


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_image_site_matches_jax_per_level_path(dtype):
    """`msmv_sample_levels` over the level-concatenated map against the JAX
    per-level path with the Pallas forward: output and the gradients for
    every level's features, the coordinates and the level weights."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    S, N, Q, P, C = 2, 2, 10, 12, 64
    hws, roffs, rcat = concat_geometry((64, 128), 4)
    levels = [rng.normal(size=(S, N, h, w, C)).astype(np.float32)
              for h, w in hws]
    x = (_pixels(rng, (S, Q, P), 128) / 127.0).astype(np.float32)
    y = (_pixels(rng, (S, Q, P), 64) / 63.0).astype(np.float32)
    view = rng.integers(0, N, (S, Q, P)).astype(np.int32)
    w = rng.uniform(size=(S, Q, P, 4)).astype(np.float32)
    g = rng.normal(size=(S, Q, P, C)).astype(np.float32)

    def jax_fn(lv, xx, yy, ww):
        maps = [jbil.fuse_rows(jbil.pad_for_sampling(f.astype(jdt), align=True))
                for f in lv]
        out = msmv_sample_xyv(maps, xx, yy, jnp.asarray(view), ww,
                              pre_fused=True, pallas=True, true_hws=hws)
        return out.astype(jnp.float32)

    want, vjp = jax.vjp(jax.jit(jax_fn), [jnp.asarray(f) for f in levels],
                        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    wl, wx_, wy_, ww_ = vjp(jnp.asarray(g))

    lt = [torch.tensor(f, requires_grad=True) for f in levels]
    xt, yt, wt = (torch.tensor(a, requires_grad=True) for a in (x, y, w))
    fmap = level_concat([f.to(tdt) for f in lt])  # [S, N, rcat, Wmax, 2C]
    got = msmv_sample_levels(fmap, xt, yt, torch.from_numpy(view), wt, hws,
                             roffs, rcat).float()
    got.backward(torch.from_numpy(g))
    close(got.detach(), want, tol, "out")
    for l in range(4):
        close(lt[l].grad, wl[l], tol, f"d_level{l}")
    for t, w_, n in ((xt, wx_, "d_x"), (yt, wy_, "d_y"), (wt, ww_, "d_w")):
        close(t.grad, w_, tol, n)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bev_site_matches_jax_per_point_path(dtype):
    """`deform_attn_single_level(fold_points=0)` against the JAX per-point
    path with the Pallas forward (`x * W - 0.5` mapping, head rows, weighted
    point sum): output and the gradients for the value map, the locations
    and the attention weights."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    S, M, H, W, c, Q, P = 2, 4, 16, 16, 64, 10, 20
    value = rng.normal(size=(S, M, H, W, c)).astype(np.float32)
    x = (_pixels(rng, (S, Q, M, P), W) / W).astype(np.float32)
    y = (_pixels(rng, (S, Q, M, P), H) / H).astype(np.float32)
    w = rng.uniform(size=(S, Q, M, P)).astype(np.float32)
    g = rng.normal(size=(S, Q, M * c)).astype(np.float32)

    def jax_fn(v, xx, yy, ww):
        fused = jbil.fuse_rows(jbil.pad_for_sampling(v.astype(jdt), align=True))
        out = jax_deform(fused, None, ww, loc_xy=(xx, yy), pre_fused=True,
                         pallas=True, true_hw=(H, W))
        return out.astype(jnp.float32)

    want, vjp = jax.vjp(jax.jit(jax_fn), *map(jnp.asarray, (value, x, y, w)))
    want_grads = vjp(jnp.asarray(g))

    ts = [torch.tensor(a, requires_grad=True) for a in (value, x, y, w)]
    got = deform_attn_single_level(sampler_ready(ts[0].to(tdt)), ts[1], ts[2],
                                   ts[3], (H, W), 0).float()
    got.backward(torch.from_numpy(g))
    close(got.detach(), want, tol, "out")
    for t, wg, n in zip(ts, want_grads, ("d_value", "d_x", "d_y", "d_w")):
        close(t.grad, wg, tol, n)
