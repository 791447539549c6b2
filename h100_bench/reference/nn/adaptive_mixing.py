"""AdaMixer-style adaptive mixing (port of
`racformer_tpu/nn/adaptive_mixing.py`): per-query generated channel-mix
M [c, c] and point-mix S [P_out, P_in] applied per group, each followed by a
LayerNorm over the last two axes (eps 1e-5, no affine) and ReLU, then an
output projection with a residual, all in `dtype` (the head's; the sampled
values are cast to it first)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Linear, flax_add


def _ln2d(x: torch.Tensor) -> torch.Tensor:
    """As the JAX package's `_ln2d`: in float32 one op; in a lower precision
    its mean and variance taken in float32 and rounded to x's dtype, the
    reciprocal square root in float32 rounded to it, the rest in x's
    dtype."""
    if x.dtype == torch.float32:
        return F.layer_norm(x, x.shape[-2:], eps=1e-5)
    xf = x.float()
    mean = xf.mean((-2, -1), keepdim=True).to(x.dtype)
    var = xf.var((-2, -1), unbiased=False, keepdim=True).to(x.dtype)
    return (x - mean) * torch.rsqrt(var.float() + 1e-5).to(x.dtype)


class AdaptiveMixing(nn.Module):
    def __init__(self, in_points: int = 96, out_points: int = 128,
                 n_groups: int = 4, embed_dims: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = embed_dims // n_groups
        self.dtype = dtype
        self.in_points, self.out_points, self.n_groups = in_points, out_points, n_groups
        self.m_params = c * c
        self.parameter_generator = Linear(
            embed_dims, n_groups * (self.m_params + in_points * out_points),
            dtype=dtype)
        self.out_proj = Linear(n_groups * out_points * c, embed_dims,
                               dtype=dtype)

    def forward(self, x: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        """x: [B, Q, G, P_in, c] sampled features; query: [B, Q, C]."""
        B, Q, G, P, c = x.shape
        dt = self.dtype
        params = self.parameter_generator(query).to(dt).reshape(B, Q, G, -1)
        m = params[..., :self.m_params].reshape(B, Q, G, c, c)
        s = params[..., self.m_params:].reshape(B, Q, G, self.out_points,
                                               self.in_points)
        out = F.relu(_ln2d(torch.matmul(x.to(dt), m)))
        out = F.relu(_ln2d(torch.matmul(s, out)))
        out = self.out_proj(out.reshape(B, Q, G * self.out_points * c))
        return flax_add(query, out, dt)
