"""Common building blocks (port of `racformer_tpu/nn/layers.py`).

Conventions, as in the JAX package:
  * activations are channel-last [B, H, W, C]; a convolution permutes to
    PyTorch's NCHW view and back, which costs no copy because the permuted
    tensor is already in channels_last memory order;
  * parameters are float32; a layer computes in its input's dtype (bf16 in
    the image trunk), casting its weights per call, unless it is given a
    compute `dtype`: then it works as flax's `dtype=` does, casting its
    input and weights at use (the head's `head_dtype`, or float32 where the
    JAX package pins a layer to it);
  * below float32 (a bf16 head) values are rounded where the JAX package's
    program rounds them on the CPU, which the tests compare against: a
    matrix product or a convolution rounds its result to the dtype; an
    elementwise op rounds its result when a bf16 op consumes it, but not
    when the consumer converts it to float32 (XLA then computes it in
    float32). So a `Linear` below float32 returns its rounded product plus
    its bias as a float32 sum (`flax_add` likewise for a residual), which
    its consumer rounds (`.to(dtype)`, a bf16 layer) or reads whole (a
    LayerNorm, a float32 layer or cast);
  * normalization layers hold the reference checkpoint's tensors (weight,
    bias, running_mean, running_var, num_batches_tracked). In eval mode they
    apply the affine map folded into one multiply-add; in train mode
    `BatchNorm` normalizes with batch statistics and updates its running
    ones with flax's semantics, `FrozenBatchNorm` never does;
  * dropout draws its masks from the generator of the enclosing
    `dropout_rng` block; outside one (and in eval mode) it is the identity.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import distributed

LN_EPS = 1e-6  # flax `nn.LayerNorm` default, which the JAX package uses
SYNCS = 0  # all-reduces made by train-mode `BatchNorm` across ranks


def flax_add(a, b, dtype):
    """a + b as the JAX package's program computes a sum in `dtype`: the
    operands rounded to `dtype`, the sum kept in float32 for its consumer
    to round or read whole (the module docstring). In float32, a + b."""
    return a.to(dtype).float() + b.to(dtype).float()


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` on channel-last tensors, in the input dtype or, given
    `dtype`, in that dtype as flax's `nn.Conv(dtype=...)`. Padding is
    symmetric, `dilation * (kernel - 1) // 2` unless given."""

    def __init__(self, cin, cout, kernel, stride=1, padding=None, dilation=1,
                 bias=True, dtype=None):
        if padding is None:
            padding = dilation * (kernel - 1) // 2
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        # a compute dtype below float32 rounds the product before the bias
        # is added, as flax does (the consumers here are bf16 ops)
        late = self.bias is not None and self.compute_dtype not in (
            None, torch.float32)
        b = None if self.bias is None or late else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding, self.dilation)
        y = y.permute(0, 2, 3, 1)
        return y + self.bias.to(dt) if late else y


class Linear(nn.Linear):
    """`nn.Linear` in `dtype` (flax `nn.Dense(dtype=...)`), or in the input
    dtype when `dtype` is None. Below float32 with a bias it returns the
    product rounded to `dtype` plus the bias, in float32 (the module
    docstring)."""

    def __init__(self, cin, cout, bias=True, dtype=None):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.compute_dtype or x.dtype)


def dense(x, weight, bias, dtype):
    """`Linear`'s product in `dtype`: F.linear in float32; below it the
    product rounded to `dtype` plus the bias in float32, as flax's Dense."""
    x, weight = x.to(dtype), weight.to(dtype)
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x, weight)
    return y if bias is None else flax_add(y, bias, dtype)


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=...)` (eps 1e-6): statistics and the affine
    map in float32, the result in `dtype` (the input dtype when None)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__(dim, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype or x.dtype)


class Embedding(nn.Embedding):
    """flax `nn.Embed(dtype=...)`: rows of the float32 table in `dtype`."""

    def __init__(self, num: int, dim: int, dtype=torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, idx):
        return self.weight.to(self.compute_dtype)[idx]


class Conv1x1Linear(nn.Conv2d):
    """A 1x1 convolution applied as a linear map over the last axis (the
    reference stores these as Conv2d weights [out, in, 1, 1])."""

    def __init__(self, cin, cout, bias=True):
        super().__init__(cin, cout, 1, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype), b)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis.

    Eval mode: the running statistics, folded into x * s + t. Train mode,
    with flax's `nn.BatchNorm` semantics (which the JAX package uses, not
    torch's): statistics over every axis but the last, in f32; the variance
    is the biased one, as E[x^2] - E[x]^2 clipped at 0 (`fast_variance`,
    flax's default) or as E[(x - E[x])^2]; the running statistics move by
    `momentum` towards the batch's, both the BIASED variance (torch's
    `F.batch_norm` would store the unbiased one). `momentum` follows torch's
    convention: flax `momentum=0.9` is 0.1 here. With several ranks
    (`utils.distributed`) the statistics cover the global batch, every
    rank's rows, so the running statistics stay equal on every rank."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, fast_variance: bool = True):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.fast_variance = fast_variance
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if not self.training:
            s = self.weight / torch.sqrt(self.running_var + self.eps)
            t = self.bias - self.running_mean * s
            return x * s.to(x.dtype) + t.to(x.dtype)
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        if distributed.world() > 1:
            mean, var = self._global_statistics(xf, dims)
        else:
            mean = xf.mean(dims)
            if self.fast_variance:
                var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
            else:
                var = ((xf - mean) ** 2).mean(dims)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
            self.num_batches_tracked += 1
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


    def _global_statistics(self, xf, dims):
        """Mean and biased variance over every rank's rows, as flax's
        BatchNorm computes them over a batch axis sharded across devices:
        the per-channel sums (of x and x^2, or of (x - mean)^2 once the
        global mean is known) and the count, all-reduced with a backward."""
        global SYNCS
        C = xf.shape[-1]
        count = xf.new_full((1,), xf.numel() // C)
        if self.fast_variance:
            s = distributed.all_reduce_sum(
                torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
            SYNCS += 1
            mean = s[:C] / s[-1]
            return mean, (s[C:2 * C] / s[-1] - mean * mean).clamp(min=0.0)
        s = distributed.all_reduce_sum(torch.cat([xf.sum(dims), count]))
        mean = s[:C] / s[-1]
        var = distributed.all_reduce_sum(((xf - mean) ** 2).sum(dims)) / s[-1]
        SYNCS += 2
        return mean, var


class FrozenBatchNorm(BatchNorm):
    """BatchNorm that always uses its running statistics (the backbone's
    `norm_eval=True`); weight and bias still get gradients."""

    def forward(self, x):
        s = self.weight / torch.sqrt(self.running_var + self.eps)
        t = self.bias - self.running_mean * s
        return x * s.to(x.dtype) + t.to(x.dtype)


class DropoutRNG:
    """Seeds for dropout masks, made on the host: every `generator()` call
    returns a fresh `torch.Generator` on `device` seeded from (seed, count),
    so a region re-run from the same seed (an activation checkpoint's
    recompute) draws the same masks. `spawn()` gives such a seed."""

    def __init__(self, seed: int, device):
        self.seed, self.device, self.count = int(seed), torch.device(device), 0

    def spawn(self) -> int:
        self.count += 1
        state = np.random.SeedSequence([self.seed, self.count]).generate_state(2)
        return int(state[0]) << 31 | int(state[1]) >> 1

    def generator(self) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(self.spawn())


_DROPOUT: list = [None]


@contextlib.contextmanager
def dropout_rng(rng: Optional[DropoutRNG]):
    """Dropout layers in train mode draw their masks from `rng` inside the
    block; None turns them off."""
    prev, _DROPOUT[0] = _DROPOUT[0], rng
    try:
        yield
    finally:
        _DROPOUT[0] = prev


def current_dropout_rng() -> Optional[DropoutRNG]:
    return _DROPOUT[0]


class Dropout(nn.Module):
    """flax `nn.Dropout`: keep with probability 1 - p and scale by 1/(1-p),
    in train mode inside a `dropout_rng` block; otherwise the identity."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x):
        rng = _DROPOUT[0]
        if not self.training or rng is None or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=rng.generator(),
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def layer_norm(dim: int, dtype=None) -> LayerNorm:
    return LayerNorm(dim, dtype)


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
    """`Upsample(mode='bilinear', align_corners=True)` on [..., H, W, C], as
    the JAX package computes it: a lerp along H, then along W, in x's dtype
    (its lerp weights and each product rounded to that dtype)."""

    def axis_interp(a, n_out, axis):
        n_in = a.shape[axis]
        if n_in == n_out:
            return a
        if n_in == 1 or n_out == 1:
            pos = torch.zeros(n_out, device=a.device)
        else:
            pos = torch.linspace(0.0, n_in - 1.0, n_out, device=a.device)
        lo = torch.floor(pos).long()
        hi = (lo + 1).clamp(max=n_in - 1)
        shape = [1] * a.dim()
        shape[axis] = n_out
        w = (pos - lo).to(a.dtype).reshape(shape)
        return (a.index_select(axis, lo) * (1 - w)
                + a.index_select(axis, hi) * w)

    x = axis_interp(x, out_hw[0], x.dim() - 3)
    return axis_interp(x, out_hw[1], x.dim() - 2)
