"""Scale-Adaptive Self-Attention (port of `racformer_tpu/nn/sasa.py`):
multi-head self-attention over the queries with the additive bias
`-||c_i - c_j|| * tau_h`, tau a learned per-head scale from the query
feature, the query-denoising group mask (True = blocked) as -inf, dropout
(0.1) on the attention weights and the output, and a residual. The
attention is written out (two batched matmuls and a softmax); the
projection weights are stored as the reference's `nn.MultiheadAttention`
stores them (`attention.attn.in_proj_weight`, ...). The projections and
the products run in `dtype`, tau, the bias and the softmax in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.bbox_codec import decode_bbox, theta_d_to_xy
from .layers import Dropout, Linear, dense, flax_add


class _AttentionWeights(nn.Module):
    def __init__(self, embed_dims: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = Linear(embed_dims, embed_dims, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)


class _AttentionShell(nn.Module):
    """Holds `attn`, as mmcv's MultiheadAttention wrapper does."""

    def __init__(self, embed_dims: int, dtype: torch.dtype):
        super().__init__()
        self.attn = _AttentionWeights(embed_dims, dtype)


class ScaleAdaptiveSelfAttention(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.pc_range = tuple(pc_range)
        self.dtype = dtype
        # sqrt(c) rounded to `dtype`, as the JAX package's
        # `jnp.sqrt(c).astype(q.dtype)`
        self.scale = float(torch.tensor(math.sqrt(embed_dims // num_heads),
                                        device="cpu").to(dtype))
        self.gen_tau = Linear(embed_dims, num_heads, dtype=torch.float32)
        self.attention = _AttentionShell(embed_dims, dtype)
        self.dropout = Dropout(0.1)

    def forward(self, query_bbox: torch.Tensor, query_feat: torch.Tensor,
                attn_mask=None):
        """query_bbox: [B, Q, 10] polar queries; query_feat: [B, Q, C];
        attn_mask: optional [Q, Q] bool, True = blocked."""
        B, Q, C = query_feat.shape
        M = self.num_heads
        c = C // M
        # the distance bias takes no gradient (as in the reference)
        centers = decode_bbox(theta_d_to_xy(query_bbox.detach()),
                              self.pc_range)[..., :2]
        dist = -torch.linalg.norm(centers[:, :, None] - centers[:, None], dim=-1)
        tau = self.gen_tau(query_feat)  # [B, Q, M]
        bias = dist[:, None] * tau.permute(0, 2, 1)[..., None]  # [B, M, Q, Q]
        if attn_mask is not None:
            bias = bias.masked_fill(attn_mask, float("-inf"))

        attn, dt = self.attention.attn, self.dtype
        qkv = dense(query_feat, attn.in_proj_weight, attn.in_proj_bias,
                    dt).to(dt)
        q, k, v = (t.reshape(B, Q, M, c).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / self.scale
        weights = torch.softmax(logits + bias, dim=-1).to(dt)
        weights = self.dropout(weights)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(B, Q, C)
        return flax_add(query_feat, self.dropout(attn.out_proj(out)), dt)
