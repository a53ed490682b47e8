"""ASPP and SceneUnder (NCHW), counterparts of the JAX package's
`nn/lss_modules.py::{ASPP, SceneUnder}` with torchvision's DeepLab key names
(`convs.{0..4}`, `project`)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import ConvBNReLU, conv_bn, conv2d, global_avg_pool


class ASPPPooling(nn.Sequential):
    """Image pooling branch: global pool -> 1x1 conv BN ReLU -> broadcast."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), conv2d(cin, cout, 1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        p = conv_bn(global_avg_pool(x), self[1], self[2], relu=True)
        return p.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    """1x1 + three dilated 3x3 + image pooling, projected by a 1x1 conv,
    then dropout 0.5 (a no-op in eval)."""

    def __init__(self, cin: int, atrous_rates: Sequence[int], features: int = 256):
        super().__init__()
        convs = [ConvBNReLU(cin, features, 1, bias=False)]
        convs += [ConvBNReLU(cin, features, 3, dilation=r, bias=False) for r in atrous_rates]
        convs.append(ASPPPooling(cin, features))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            conv2d(features * len(convs), features, 1, bias=False), nn.BatchNorm2d(features),
            nn.ReLU(inplace=True), nn.Dropout(0.5),
        )

    def forward(self, x):
        y = torch.cat([m(x) for m in self.convs], dim=1)
        return self.project[3](conv_bn(y, self.project[0], self.project[1], relu=True))


class SceneUnder(nn.Sequential):
    """ASPP(in, [12, 24, 36]), held at index 0 as in the original model."""

    def __init__(self, cin: int = 256):
        super().__init__(ASPP(cin, (12, 24, 36)))
