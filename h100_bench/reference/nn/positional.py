"""Learned 2D positional encoding for BEV maps (port of
`racformer_tpu/nn/positional.py`; mmcv LearnedPositionalEncoding)."""

from __future__ import annotations

import torch
import torch.nn as nn


class LearnedPositionalEncoding2D(nn.Module):
    def __init__(self, num_feats: int = 128, rows: int = 128, cols: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.row_embed = nn.Embedding(rows, num_feats)
        self.col_embed = nn.Embedding(cols, num_feats)

    def forward(self, h: int, w: int) -> torch.Tensor:
        """Returns [h, w, 2 * num_feats] in `dtype` (flax `nn.Embed`'s rows
        in its compute dtype): column embedding broadcast over rows, then
        row embedding broadcast over columns (mmcv layout)."""
        col = self.col_embed.weight[:w].to(self.dtype)
        row = self.row_embed.weight[:h].to(self.dtype)
        return torch.cat([col[None, :, :].expand(h, w, -1),
                          row[:, None, :].expand(h, w, -1)], dim=-1)
