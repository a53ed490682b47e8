"""Stack A's building blocks and the ASPP (NCHW), counterparts of the JAX
package's `nn/lss_modules.py`, with the original repo's key names: the
camera encoder (`encoder.trunk`, `encoder.up1`, `camencode.depthnet`),
torchvision's resnet18 body in the BEV decoder (`conv1`, `bn1`,
`layer{1,2,3}.{0,1}`, `up1`, `up2.{1,2,4}`), the TXT heads (`post.{0,1}`,
Sequential indices) and torchvision's DeepLab ASPP (`convs.{0..4}`,
`project`)."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sampling import resize_bilinear
from .efficientnet import EfficientNetTrunk, encoder_channels
from .layers import ConvBNReLU, Up, conv_bn, conv2d, global_avg_pool, linear, max_pool


class Encoder(nn.Module):
    """EfficientNet trunk, then Up(reduction_5, reduction_4) into 512
    channels at stride 16."""

    def __init__(self, variant: str = "b4", out_features: int = 512):
        super().__init__()
        self.trunk = EfficientNetTrunk(variant)
        c5, c4 = encoder_channels(variant)
        self.up1 = Up(c5 + c4, out_features)

    def forward(self, x):
        eps = self.trunk(x)
        return self.up1(eps["reduction_5"], eps["reduction_4"])


class CamEncode(nn.Module):
    """LSS v1's depth net: a 1x1 conv to D + C channels; forward returns
    (depth (B, D, H, W), softmax over the first D; feat (B, C, H, W))."""

    def __init__(self, depth_bins: int, features: int, cin: int = 512):
        super().__init__()
        self.depth_bins = depth_bins
        self.depthnet = nn.Conv2d(cin, depth_bins + features, 1)

    def forward(self, x):
        x = conv_bn(x, self.depthnet)
        return torch.softmax(x[:, :self.depth_bins], dim=1), x[:, self.depth_bins:]


class BasicBlock(nn.Module):
    """torchvision's resnet BasicBlock; bn2's scale starts at 0, as
    `resnet18(zero_init_residual=True)` builds it."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv2d(cin, cout, 3, stride=stride, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = conv2d(cout, cout, 3, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        nn.init.zeros_(self.bn2.weight)
        self.downsample = (nn.Sequential(conv2d(cin, cout, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = conv_bn(x, self.conv1, self.bn1, relu=True)
        y = conv_bn(y, self.conv2, self.bn2)
        identity = x if self.downsample is None else conv_bn(x, *self.downsample)
        return F.relu(y + identity)


@contextmanager
def _cudnn_off_for_float32(x: torch.Tensor):
    """cuDNN off for the block where x is a float32 CUDA tensor: PyTorch's
    own conv (im2col and a cuBLAS product, full float32 under the pin) runs
    instead, and the flag is restored after."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        yield
        return
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


class BevEncode(nn.Module):
    """BEV decoder: resnet18's conv1 (7x7 / 2) and layers 1-3, Up(x4)
    against layer 1, a x2 bilinear resize (align_corners=True), conv-BN-ReLU
    to 128 and a 1x1 output conv with bias.

    In float32 on the card the 3x3 conv at 200x200 runs without cuDNN:
    with TF32 off, cuDNN's heuristic algorithm for it (FFT over 33024
    frequencies, one small launch each) takes 151-234 ms at B=1 and 375-401
    ms at B=6 on an H100, and none of its others is faster; PyTorch's
    im2col and cuBLAS take 0.83 and 4.97 ms, within 5.3e-7 of float64 as
    cuDNN is (`scripts/port_stack_a_convs.py`, three runs, NVIDIA H100 80GB
    HBM3, 700.00 W)."""

    def __init__(self, cin: int, out_features: int):
        super().__init__()
        self.conv1 = conv2d(cin, 64, 7, stride=2, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.up1 = Up(64 + 256, 256)  # x4 from layer 3 to layer 1's size
        self.up2 = nn.Sequential(  # the original's indices; forward resizes itself
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            conv2d(256, 128, 3, bias=False), nn.BatchNorm2d(128), nn.ReLU(inplace=True),
            conv2d(128, out_features, 1))

    def forward(self, x):
        x = conv_bn(x, self.conv1, self.bn1, relu=True)
        x1 = self.layer1(x)
        x = self.up1(self.layer3(self.layer2(x1)), x1)
        x = resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)
        with _cudnn_off_for_float32(x):
            x = conv_bn(x, self.up2[1], self.up2[2], relu=True)
        return conv_bn(x, self.up2[4])


BEV_POST_POOL = (5, 4)


class BevPost(nn.Module):
    """The BEV crop's encoder: conv-BN-ReLU 3x3 at stride (2, 1), then a
    (5, 4) max pool; the (80, 88) crop becomes (8, 22), the camera features'
    size."""

    def __init__(self, cin: int = 4, out_features: int = 8):
        super().__init__()
        self.post = nn.Sequential(conv2d(cin, out_features, 3, stride=(2, 1), bias=False),
                                  nn.BatchNorm2d(out_features), nn.ReLU(inplace=True))

    @staticmethod
    def out_size(h: int, w: int) -> Tuple[int, int]:
        """The output's (H, W) for an (h, w) crop."""
        return ((h - 1) // 2 + 1) // BEV_POST_POOL[0], w // BEV_POST_POOL[1]

    def forward(self, x):
        return max_pool(conv_bn(x, self.post[0], self.post[1], relu=True),
                        BEV_POST_POOL, BEV_POST_POOL)


class Embedder(nn.Module):
    """conv-BN-ReLU 3x3, flatten in (C, H, W) order, linear: the fused form
    of EmbedderConv and EmbedderFlat, with the JAX module's names."""

    def __init__(self, cin: int, out_features: int, hw: Tuple[int, int]):
        super().__init__()
        self.conv = ConvBNReLU(cin, out_features, 3, bias=False)
        self.fc = nn.Linear(out_features * hw[0] * hw[1], out_features)

    def forward(self, x):
        return linear(self.conv(x).flatten(1), self.fc)


class EmbedderConv(ConvBNReLU):
    """conv-BN-ReLU 3x3 without bias (`.0`, `.1`)."""

    def __init__(self, cin: int, out_features: int):
        super().__init__(cin, out_features, 3, bias=False)


class EmbedderFlat(nn.Sequential):
    """Flatten in (C, H, W) order, then a linear (`.1`)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(nn.Flatten(), nn.Linear(in_features, out_features))

    def forward(self, x):
        return linear(x.flatten(1), self[1])


class Predictor(nn.Sequential):
    """A bare linear head (`.0`)."""

    def __init__(self, in_features: int, classes: int):
        super().__init__(nn.Linear(in_features, classes))

    def forward(self, x):
        return linear(x, self[0])


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
