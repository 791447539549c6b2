"""VoVNet backbone family, V-19 / 39 / 57 / 99 with eSE (port of
`racformer_tpu/nn/vovnet.py`): a stem of three 3x3 convs (stride 2, 1, 2),
then four stages of OSA (one-shot aggregation) modules, a chain of 3x3
convs whose outputs are concatenated with the input and fused by a 1x1,
gated by an effective squeeze-excite (eSE, hard-sigmoid gate), with the
identity added on each stage's blocks after the first; a 3x3 stride-2
max-pool (padding 1) before every stage but the first. Channel-last, in
`dtype` from float32 parameters, BatchNorm frozen by default (the
reference's `norm_eval=True`).

The max-pool is the JAX package's (padding 1, -inf border); the public
VoVNet pools with `nn.MaxPool2d(3, 2, ceil_mode=True)` and no padding,
which gives the same sizes with windows one pixel apart. No model of
either package selects this backbone.

State-dict names are the public VoVNet's: `stem.stem_1/conv.weight`,
`stage2.OSA2_1.layers.0.OSA2_1_0/conv.weight`,
`stage2.OSA2_1.concat.OSA2_1_concat/norm.running_mean`,
`stage2.OSA2_1.ese.fc.weight`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import BatchNorm, Conv1x1Linear, Conv2d, FrozenBatchNorm

SPECS: Dict[str, Dict] = {
    "V-19-slim-eSE": dict(stem=(64, 64, 128), stage_conv=(64, 80, 96, 112),
                          stage_out=(112, 256, 384, 512), layers=3,
                          blocks=(1, 1, 1, 1)),
    "V-19-eSE": dict(stem=(64, 64, 128), stage_conv=(128, 160, 192, 224),
                     stage_out=(256, 512, 768, 1024), layers=3,
                     blocks=(1, 1, 1, 1)),
    "V-39-eSE": dict(stem=(64, 64, 128), stage_conv=(128, 160, 192, 224),
                     stage_out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 1, 2, 2)),
    "V-57-eSE": dict(stem=(64, 64, 128), stage_conv=(128, 160, 192, 224),
                     stage_out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 1, 4, 3)),
    "V-99-eSE": dict(stem=(64, 64, 128), stage_conv=(128, 160, 192, 224),
                     stage_out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 3, 9, 3)),
}
NORMS = {"frozen_bn": FrozenBatchNorm, "bn": BatchNorm}


def conv_norm(cin: int, cout: int, kernel: int, name: str, norm: str,
              stride: int = 1):
    """The JAX package's `ConvNorm` as the public code's named modules: a
    bias-free conv (padding kernel // 2), a norm (`NORMS`) and a ReLU."""
    return [(f"{name}/conv", Conv2d(cin, cout, kernel, stride=stride,
                                    padding=kernel // 2, bias=False)),
            (f"{name}/norm", NORMS[norm](cout)),
            (f"{name}/relu", nn.ReLU())]


class ConvNorm(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel: int, name: str,
                 norm: str = "frozen_bn"):
        super().__init__(OrderedDict(conv_norm(cin, cout, kernel, name, norm)))


class ESE(nn.Module):
    """Effective squeeze-excite: the spatial mean, a 1x1 conv (`fc`) and
    the hard-sigmoid gate clip(s / 6 + 0.5, 0, 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv1x1Linear(channels, channels)

    def forward(self, x):
        s = self.fc(x.float().mean((1, 2)).to(x.dtype))
        return x * torch.clamp(s / 6.0 + 0.5, 0.0, 1.0)[:, None, None, :]


class OSAModule(nn.Module):
    def __init__(self, cin: int, stage_ch: int, concat_ch: int, layers: int,
                 name: str, identity: bool = False, norm: str = "frozen_bn"):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList()
        ch = cin
        for i in range(layers):
            self.layers.append(ConvNorm(ch, stage_ch, 3, f"{name}_{i}", norm))
            ch = stage_ch
        self.concat = ConvNorm(cin + layers * stage_ch, concat_ch, 1,
                               f"{name}_concat", norm)
        self.ese = ESE(concat_ch)

    def forward(self, x):
        outs, h = [x], x
        for layer in self.layers:
            h = layer(h)
            outs.append(h)
        out = self.ese(self.concat(torch.cat(outs, dim=-1)))
        return out + x if self.identity else out


class VoVNet(nn.Module):
    def __init__(self, spec_name: str = "V-99-eSE",
                 out_stages: Sequence[int] = (2, 3, 4, 5),
                 norm: str = "frozen_bn", remat: bool = True,
                 dtype: torch.dtype = torch.float32):
        """`out_stages`: which of stages 2-5 to return; `remat`: in train
        mode with gradients, each OSA block runs under
        `torch.utils.checkpoint` (the JAX package's `nn.remat`)."""
        super().__init__()
        spec = SPECS[spec_name]
        self.out_stages, self.remat, self.dtype = tuple(out_stages), remat, dtype
        s1, s2, s3 = spec["stem"]
        self.stem = nn.Sequential(OrderedDict(
            conv_norm(3, s1, 3, "stem_1", norm, stride=2)
            + conv_norm(s1, s2, 3, "stem_2", norm)
            + conv_norm(s2, s3, 3, "stem_3", norm, stride=2)))
        cin = s3
        for si in range(4):
            n = si + 2
            stage = nn.Sequential()
            for b in range(spec["blocks"][si]):
                stage.add_module(f"OSA{n}_{b + 1}", OSAModule(
                    cin, spec["stage_conv"][si], spec["stage_out"][si],
                    spec["layers"], f"OSA{n}_{b + 1}", identity=b > 0,
                    norm=norm))
                cin = spec["stage_out"][si]
            self.add_module(f"stage{n}", stage)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        """x: [B, H, W, 3] -> the `out_stages` maps (strides 4, 8, 16, 32)
        in `dtype`."""
        x = self.stem(x.to(self.dtype))
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for n in range(2, 6):
            if n != 2:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                                 padding=1).permute(0, 2, 3, 1)
            for block in getattr(self, f"stage{n}"):
                x = checkpoint(block, x, use_reentrant=False) if remat \
                    else block(x)
            if n in self.out_stages:
                outs.append(x)
        return tuple(outs)
