"""AdaMixer-style adaptive mixing (port of
`racformer_tpu/nn/adaptive_mixing.py`): per-query generated channel-mix
M [c, c] and point-mix S [P_out, P_in] applied per group, each followed by a
LayerNorm over the last two axes (eps 1e-5, no affine) and ReLU, then an
output projection with a residual."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Linear


def _ln2d(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-2:], eps=1e-5)


class AdaptiveMixing(nn.Module):
    def __init__(self, in_points: int = 96, out_points: int = 128,
                 n_groups: int = 4, embed_dims: int = 256):
        super().__init__()
        c = embed_dims // n_groups
        self.in_points, self.out_points, self.n_groups = in_points, out_points, n_groups
        self.m_params = c * c
        self.parameter_generator = Linear(
            embed_dims, n_groups * (self.m_params + in_points * out_points))
        self.out_proj = Linear(n_groups * out_points * c, embed_dims)

    def forward(self, x: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        """x: [B, Q, G, P_in, c] sampled features; query: [B, Q, C]."""
        B, Q, G, P, c = x.shape
        params = self.parameter_generator(query).reshape(B, Q, G, -1)
        m = params[..., :self.m_params].reshape(B, Q, G, c, c)
        s = params[..., self.m_params:].reshape(B, Q, G, self.out_points,
                                               self.in_points)
        out = F.relu(_ln2d(torch.matmul(x.to(m.dtype), m)))
        out = F.relu(_ln2d(torch.matmul(s, out)))
        out = self.out_proj(out.reshape(B, Q, G * self.out_points * c))
        return query + out
