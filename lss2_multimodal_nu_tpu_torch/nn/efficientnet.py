"""EfficientNet B0-B7 camera trunk (NCHW), counterpart of the JAX package's
`nn/efficientnet.py` with efficientnet_pytorch's key names: `_conv_stem`,
`_bn0`, `_blocks.{i}._expand_conv`, `._bn0`, `._depthwise_conv`, `._bn1`,
`._se_reduce`, `._se_expand`, `._project_conv`, `._bn2`.

Swish activations, squeeze-excitation at 0.25 of the block's *input*
channels, batch norm with eps 1e-3 and torch momentum 0.01, stochastic depth
at `0.2 * idx / n_blocks` on the residual blocks. Every strided conv pads as
efficientnet_pytorch's `Conv2dStaticSamePadding` does: from the size the
model was built for (`IMAGE_SIZE`), not from the input. At b4's third
stride that size is 95, which pads (2, 2) where dynamic SAME at a 128-row
input would pad (1, 2); an uneven pad runs as `F.pad` before an unpadded
conv. Stride-1 convs pad (k - 1) / 2 on each side.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import DropConnect, conv_bn, global_avg_pool

# (width_coefficient, depth_coefficient)
SCALING = {
    "b0": (1.0, 1.0),
    "b1": (1.0, 1.1),
    "b2": (1.1, 1.2),
    "b3": (1.2, 1.4),
    "b4": (1.4, 1.8),
    "b5": (1.6, 2.2),
    "b6": (1.8, 2.6),
    "b7": (2.0, 3.1),
}

# b0's stages: (expand_ratio, kernel, stride, channels, repeats)
BASE_STAGES = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]

# the size each variant is built for (efficientnet_pytorch's
# `efficientnet_params`), from which its static pads follow
IMAGE_SIZE = {
    "b0": 224, "b1": 240, "b2": 260, "b3": 300,
    "b4": 380, "b5": 456, "b6": 528, "b7": 600,
}

BN_EPS, BN_MOMENTUM = 1e-3, 0.01
DROP_CONNECT_RATE = 0.2


def static_same_pad(size: int, kernel: int, stride: int) -> Tuple[Tuple[int, int], int]:
    """((lo, hi) pad, output size) of one spatial dim of a conv built for
    `size`."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return (total // 2, total - total // 2), out


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


Block = Tuple[int, int, int, int, int, Tuple[int, int], float]


def trunk_blocks(variant: str) -> Tuple[int, Tuple[int, int], List[Block]]:
    """(stem channels, stem pad, blocks), each block (in_ch, out_ch,
    expand_ratio, kernel, stride, (lo, hi) pad of its depthwise conv,
    drop-connect rate), walked as efficientnet_pytorch builds them."""
    width, depth = SCALING[variant]
    stem_ch = round_filters(32, width)
    stem_pad, size = static_same_pad(IMAGE_SIZE[variant], 3, 2)
    shapes = []
    in_ch = stem_ch
    for expand, k, s, c, r in BASE_STAGES:
        out_ch = round_filters(c, width)
        for i in range(round_repeats(r, depth)):
            shapes.append((in_ch, out_ch, expand, k, s if i == 0 else 1))
            in_ch = out_ch
    blocks = []
    for idx, (ic, oc, er, k, s) in enumerate(shapes):
        pad, size = static_same_pad(size, k, s)
        blocks.append((ic, oc, er, k, s, pad, DROP_CONNECT_RATE * idx / len(shapes)))
    return stem_ch, stem_pad, blocks


def encoder_channels(variant: str) -> Tuple[int, int]:
    """(reduction_5, reduction_4) channels, the Encoder's Up inputs."""
    width, _ = SCALING[variant]
    return round_filters(320, width), round_filters(112, width)


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def _padded_conv(cin: int, cout: int, k: int, stride: int, pad: Tuple[int, int],
                 groups: int = 1) -> Tuple[nn.Conv2d, Tuple[int, int, int, int] | None]:
    """A bias-free conv with the static pad: the conv's own padding where
    the pad is even, else (F.pad's pad, an unpadded conv)."""
    lo, hi = pad
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=lo if lo == hi else 0,
                     groups=groups, bias=False)
    return conv, None if lo == hi else (lo, hi, lo, hi)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int, kernel: int, stride: int,
                 pad: Tuple[int, int], drop_rate: float = 0.0, se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand_ratio
        if expand_ratio != 1:
            self._expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv, self._pad = _padded_conv(mid, mid, kernel, stride, pad, groups=mid)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(in_ch * se_ratio))
        self._se_reduce = nn.Conv2d(mid, se_ch, 1)
        self._se_expand = nn.Conv2d(se_ch, mid, 1)
        self._project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self._bn2 = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch
        self.drop_connect = DropConnect(drop_rate)

    def forward(self, x):
        inp = x
        if hasattr(self, "_expand_conv"):
            x = F.silu(conv_bn(x, self._expand_conv, self._bn0))
        if self._pad is not None:
            x = F.pad(x, self._pad)
        x = F.silu(conv_bn(x, self._depthwise_conv, self._bn1))
        s = F.silu(conv_bn(global_avg_pool(x), self._se_reduce))
        x = x * torch.sigmoid(conv_bn(s, self._se_expand))
        x = conv_bn(x, self._project_conv, self._bn2)
        if self.residual:
            x = inp + self.drop_connect(x)
        return x


class EfficientNetTrunk(nn.Module):
    """Stem and MBConv blocks; forward returns {reduction_1..5}: reduction_k
    is the map before the k-th spatial reduction, reduction_5 the last
    block's output."""

    def __init__(self, variant: str = "b4"):
        super().__init__()
        stem_ch, stem_pad, blocks = trunk_blocks(variant)
        self._conv_stem, self._stem_pad = _padded_conv(3, stem_ch, 3, 2, stem_pad)
        self._bn0 = _bn(stem_ch)
        self._blocks = nn.ModuleList(MBConv(ic, oc, er, k, s, pad, rate)
                                     for ic, oc, er, k, s, pad, rate in blocks)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if self._stem_pad is not None:
            x = F.pad(x, self._stem_pad)
        x = F.silu(conv_bn(x, self._conv_stem, self._bn0))
        endpoints: Dict[str, torch.Tensor] = {}
        prev = x
        for block in self._blocks:
            x = block(x)
            if prev.shape[2] > x.shape[2]:
                endpoints[f"reduction_{len(endpoints) + 1}"] = prev
            prev = x
        endpoints[f"reduction_{len(endpoints) + 1}"] = x
        return endpoints
