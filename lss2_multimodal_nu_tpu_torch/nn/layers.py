"""Shared building blocks (NCHW).

Parameters stay float32 and are cast to the activation's dtype where they
are used, as the JAX package does (`nn/layers.py`). In eval, batch norm is
folded into the preceding conv with the running statistics. In training
(`bn.training`) it normalises with the batch statistics, taken in float32,
and updates the running statistics with torch's momentum 0.1 (flax's 0.9)
and torch's unbiased variance (flax keeps the biased one; ROADMAP.md
fault e).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sampling import resize_bilinear


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d] = None,
            relu: bool = False) -> torch.Tensor:
    """conv (+ batch norm) (+ ReLU) in x's dtype. Eval batch norm is folded
    into the conv's weights; train batch norm runs after the conv."""
    w, b = conv.weight, conv.bias
    if bn is not None and bn.training:
        y = F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                     conv.stride, conv.padding, conv.dilation, conv.groups)
        bn.num_batches_tracked.add_(1)
        y = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=True, momentum=bn.momentum, eps=bn.eps).to(x.dtype)
        return F.relu(y) if relu else y
    if bn is not None:
        g = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * g
        w = w * g[:, None, None, None]
        b = shift if b is None else shift + b * g
    y = F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    return F.relu(y) if relu else y


def linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype))


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with float32 statistics, result in x's dtype."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(x.dtype)


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """VoVNet's 3x3 / stride-2 ceil-mode pool (a last window that would start
    in the padding is dropped, as torch does)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def max_pool(x: torch.Tensor, window: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
    """`nn.MaxPool2d(window, stride)` without padding or ceil mode (BevPost's
    (5, 4) pool)."""
    return F.max_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=keepdim)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def conv2d(cin: int, cout: int, k: int, dilation: int = 1, stride: int = 1,
           bias: bool = True) -> nn.Conv2d:
    """Conv with torch's symmetric padding dilation*(k-1)//2."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k - 1) // 2,
                     dilation=dilation, bias=bias)


class ConvBnAct(nn.Module):
    """timm's ConvBnAct naming (`.conv`, `.bn`): conv without bias, BN, ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.conv = conv2d(cin, cout, k, stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return conv_bn(x, self.conv, self.bn, relu=True)


class ConvBNReLU(nn.Sequential):
    """Sequential(conv, bn, ReLU), the original repo's naming (`.0`, `.1`)."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, bias: bool = True):
        super().__init__(conv2d(cin, cout, k, dilation, bias=bias), nn.BatchNorm2d(cout),
                         nn.ReLU(inplace=True))

    def forward(self, x):
        return conv_bn(x, self[0], self[1], relu=True)


class DropConnect(nn.Module):
    """Per-sample stochastic depth (efficientnet_pytorch's `drop_connect`):
    in training, each sample's branch is kept with probability 1 - rate and
    scaled by 1 / (1 - rate), the mask drawn from torch's default generator
    on x's device (the train step seeds it per step); the identity in
    eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return x / keep * mask.to(x.dtype)


class Up(nn.Module):
    """Bilinear resize of x1 to the skip x2's size (align_corners=True; the
    original's x`scale` upsampling where sizes divide), concat [x2, x1],
    then two conv-BN-ReLU (`conv.0/1`, `conv.3/4`, the original's names)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            conv2d(cin, cout, 3, bias=False), nn.BatchNorm2d(cout), nn.ReLU(inplace=True),
            conv2d(cout, cout, 3, bias=False), nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x1, x2):
        x1 = resize_bilinear(x1, x2.shape[-2:], align_corners=True)
        x = torch.cat([x2, x1], dim=1)
        x = conv_bn(x, self.conv[0], self.conv[1], relu=True)
        return conv_bn(x, self.conv[3], self.conv[4], relu=True)
