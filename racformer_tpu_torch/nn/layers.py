"""Common building blocks (port of `racformer_tpu/nn/layers.py`).

Conventions, as in the JAX package:
  * activations are channel-last [B, H, W, C]; a convolution permutes to
    PyTorch's NCHW view and back, which costs no copy because the permuted
    tensor is already in channels_last memory order;
  * parameters are float32; a layer computes in its input's dtype (bf16 in
    the image trunk, f32 in the head), casting its weights per call;
  * normalization layers hold the reference checkpoint's tensors (weight,
    bias, running_mean, running_var, num_batches_tracked) and apply the
    eval-mode affine map folded into one multiply-add.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6  # flax `nn.LayerNorm` default, which the JAX package uses


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` on channel-last tensors, in the input dtype. Padding is
    symmetric, `dilation * (kernel - 1) // 2` unless given."""

    def __init__(self, cin, cout, kernel, stride=1, padding=None, dilation=1,
                 bias=True):
        if padding is None:
            padding = dilation * (kernel - 1) // 2
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         dilation=dilation, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     self.stride, self.padding, self.dilation)
        return y.permute(0, 2, 3, 1)


class Linear(nn.Linear):
    """`nn.Linear` in the input dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv1x1Linear(nn.Conv2d):
    """A 1x1 convolution applied as a linear map over the last axis (the
    reference stores these as Conv2d weights [out, in, 1, 1])."""

    def __init__(self, cin, cout, bias=True):
        super().__init__(cin, cout, 1, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype), b)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis, folded into x * s + t."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        s = self.weight / torch.sqrt(self.running_var + self.eps)
        t = self.bias - self.running_mean * s
        return x * s.to(x.dtype) + t.to(x.dtype)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class ConvModule(nn.Module):
    """mmcv ConvModule: `.conv`, optional `.bn`, optional ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, dilation=1, bias=None,
                 norm=True, act=True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, dilation=dilation,
                           bias=(not norm) if bias is None else bias)
        self.bn = BatchNorm(cout) if norm else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class Mlp(nn.Module):
    """fc1 -> ReLU -> fc2 (the DepthNet `Mlp`)."""

    def __init__(self, cin, hidden, cout):
        super().__init__()
        self.fc1 = Linear(cin, hidden)
        self.fc2 = Linear(hidden, cout)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Camera-aware squeeze-excite: x [B, H, W, C] scaled by a gate computed
    from the conditioning vector x_se [B, C]."""

    def __init__(self, channels):
        super().__init__()
        self.conv_reduce = Conv1x1Linear(channels, channels)
        self.conv_expand = Conv1x1Linear(channels, channels)

    def forward(self, x, x_se):
        s = self.conv_expand(F.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(s)[:, None, None, :]


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """`Upsample(mode='bilinear', align_corners=True)` on [..., H, W, C]."""
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    y = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(out_hw), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, C)
