"""Plain reference of `BevTxt`, the published Multimodal-XAD model: an
EfficientNet trunk with its Up into 512 channels, LSS v1's depth net,
lift-splat, torchvision's resnet18 body as the BEV decoder, and the TXT
branch (the BEV crop's encoder beside the ASPP'd camera features). Module and
parameter names are the port's (efficientnet_pytorch's and the original
repo's), so one state dict loads into both. Every kernel is its plain
composite (`common.py`).

Layer equations: the original repo's `src/model_BEV_TXT.py` and
`src/modules.py`, efficientnet_pytorch's `EfficientNet`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import (ConvBNReLU, SceneUnder, Up, conv2d, conv_bn, frustum, geometry, grid_sizes,
                     lift_splat, linear, no_cudnn, resize_bilinear, voxel_indices)

SCALING = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
           "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1)}
# b0's stages: (expand_ratio, kernel, stride, channels, repeats)
BASE_STAGES = [(1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2), (6, 3, 2, 80, 3),
               (6, 5, 1, 112, 3), (6, 5, 2, 192, 4), (6, 3, 1, 320, 1)]
# the size each variant is built for: its static SAME pads follow from it
IMAGE_SIZE = {"b0": 224, "b1": 240, "b2": 260, "b3": 300, "b4": 380, "b5": 456, "b6": 528,
              "b7": 600}
BN_EPS, BN_MOMENTUM, DROP_CONNECT_RATE = 1e-3, 0.01, 0.2
# the BEV crop that the TXT branch reads, and BevPost's pool
CROP_X, CROP_Y, POST_POOL = (60, 140), (56, 144), (5, 4)


def static_same_pad(size, kernel, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return (total // 2, total - total // 2), out


def round_filters(filters, width, divisor=8):
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * filters else new)


def trunk_blocks(variant):
    width, depth = SCALING[variant]
    stem_pad, size = static_same_pad(IMAGE_SIZE[variant], 3, 2)
    shapes, in_ch = [], round_filters(32, width)
    for expand, k, s, c, r in BASE_STAGES:
        out_ch = round_filters(c, width)
        for i in range(int(math.ceil(depth * r))):
            shapes.append((in_ch, out_ch, expand, k, s if i == 0 else 1))
            in_ch = out_ch
    blocks = []
    for idx, (ic, oc, er, k, s) in enumerate(shapes):
        pad, size = static_same_pad(size, k, s)
        blocks.append((ic, oc, er, k, s, pad, DROP_CONNECT_RATE * idx / len(shapes)))
    return round_filters(32, width), stem_pad, blocks


def _bn(ch):
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def _padded_conv(cin, cout, k, stride, pad, groups=1):
    lo, hi = pad
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=lo if lo == hi else 0, groups=groups,
                     bias=False)
    return conv, None if lo == hi else (lo, hi, lo, hi)


class MBConv(nn.Module):
    """Inverted bottleneck, squeeze-excitation at 0.25 of the input's
    channels, per-sample drop-connect on the residual while training (the
    mask from torch's default generator on x's device)."""

    def __init__(self, in_ch, out_ch, expand_ratio, kernel, stride, pad, drop_rate):
        super().__init__()
        mid = in_ch * expand_ratio
        if expand_ratio != 1:
            self._expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv, self._pad = _padded_conv(mid, mid, kernel, stride, pad, groups=mid)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(in_ch * 0.25))
        self._se_reduce = nn.Conv2d(mid, se_ch, 1)
        self._se_expand = nn.Conv2d(se_ch, mid, 1)
        self._project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self._bn2 = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch
        self.drop_rate = drop_rate

    def forward(self, x):
        inp = x
        if hasattr(self, "_expand_conv"):
            x = F.silu(conv_bn(x, self._expand_conv, self._bn0))
        if self._pad is not None:
            x = F.pad(x, self._pad)
        x = F.silu(conv_bn(x, self._depthwise_conv, self._bn1))
        s = F.silu(conv_bn(x.mean(dim=(2, 3), keepdim=True), self._se_reduce))
        x = x * torch.sigmoid(conv_bn(s, self._se_expand))
        x = conv_bn(x, self._project_conv, self._bn2)
        if not self.residual:
            return x
        if self.training and self.drop_rate > 0:
            keep = 1.0 - self.drop_rate
            mask = torch.rand((x.shape[0], 1, 1, 1), device=x.device) < keep
            x = x / keep * mask.to(x.dtype)
        return inp + x


class EfficientNetTrunk(nn.Module):
    def __init__(self, variant):
        super().__init__()
        stem_ch, stem_pad, blocks = trunk_blocks(variant)
        self._conv_stem, self._stem_pad = _padded_conv(3, stem_ch, 3, 2, stem_pad)
        self._bn0 = _bn(stem_ch)
        self._blocks = nn.ModuleList(MBConv(*b) for b in blocks)

    def forward(self, x):
        """{reduction_k}: the map before the k-th spatial reduction; the last
        the final block's output."""
        if self._stem_pad is not None:
            x = F.pad(x, self._stem_pad)
        x = F.silu(conv_bn(x, self._conv_stem, self._bn0))
        ends, prev = {}, x
        for block in self._blocks:
            x = block(x)
            if prev.shape[2] > x.shape[2]:
                ends[f"reduction_{len(ends) + 1}"] = prev
            prev = x
        ends[f"reduction_{len(ends) + 1}"] = x
        return ends


class Encoder(nn.Module):
    def __init__(self, variant, out_features=512):
        super().__init__()
        self.trunk = EfficientNetTrunk(variant)
        width = SCALING[variant][0]
        self.up1 = Up(round_filters(320, width) + round_filters(112, width), out_features)

    def forward(self, x):
        ends = self.trunk(x)
        return self.up1(ends["reduction_5"], ends["reduction_4"])


class CamEncode(nn.Module):
    def __init__(self, depth_bins, features, cin=512):
        super().__init__()
        self.depth_bins = depth_bins
        self.depthnet = nn.Conv2d(cin, depth_bins + features, 1)

    def forward(self, x):
        x = conv_bn(x, self.depthnet)
        return torch.softmax(x[:, :self.depth_bins], dim=1), x[:, self.depth_bins:]


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = conv2d(cin, cout, 3, stride=stride, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = conv2d(cout, cout, 3, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = (nn.Sequential(conv2d(cin, cout, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = conv_bn(conv_bn(x, self.conv1, self.bn1, relu=True), self.conv2, self.bn2)
        return F.relu(y + (x if self.downsample is None else conv_bn(x, *self.downsample)))


class BevEncode(nn.Module):
    def __init__(self, cin, out_features):
        super().__init__()
        self.conv1 = conv2d(cin, 64, 7, stride=2, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.up1 = Up(64 + 256, 256)
        self.up2 = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            conv2d(256, 128, 3, bias=False), nn.BatchNorm2d(128), nn.ReLU(inplace=True),
            conv2d(128, out_features, 1))

    def forward(self, x):
        x = conv_bn(x, self.conv1, self.bn1, relu=True)
        x1 = self.layer1(x)
        x = self.up1(self.layer3(self.layer2(x1)), x1)
        x = resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)
        with no_cudnn(x):
            x = conv_bn(x, self.up2[1], self.up2[2], relu=True)
        return conv_bn(x, self.up2[4])


class BevPost(nn.Module):
    def __init__(self, cin=4, out_features=8):
        super().__init__()
        self.post = nn.Sequential(conv2d(cin, out_features, 3, stride=(2, 1), bias=False),
                                  nn.BatchNorm2d(out_features), nn.ReLU(inplace=True))

    def forward(self, x):
        return F.max_pool2d(conv_bn(x, self.post[0], self.post[1], relu=True), POST_POOL,
                            POST_POOL)


class EmbedderConv(ConvBNReLU):
    def __init__(self, cin, out_features):
        super().__init__(cin, out_features, 3, bias=False)


class EmbedderFlat(nn.Sequential):
    def __init__(self, in_features, out_features):
        super().__init__(nn.Flatten(), nn.Linear(in_features, out_features))

    def forward(self, x):
        return linear(x.flatten(1), self[1])


class Predictor(nn.Sequential):
    def __init__(self, in_features, classes):
        super().__init__(nn.Linear(in_features, classes))

    def forward(self, x):
        return linear(x, self[0])


class BevTxt(nn.Module):
    """forward(imgs, rots, trans, intrins, post_rots, post_trans) -> (bev
    (B, 4, X, Y), act (B, 4), desc (B, 8)); the TXT branch reads the BEV
    crop detached and every camera's ASPP'd features but CAM_BACK's."""

    def __init__(self, cfg: dict):
        super().__init__()
        mc, grid, aug = cfg["model"], cfg["grid"], cfg["aug"]
        self.dx, self.bx, self.nx = grid_sizes(grid)
        self.frustum_np = frustum(aug["final_dim"], grid["dbound"], mc["downsample"])
        self.depth_bins = self.frustum_np.shape[0]
        self.cam_c = mc["cam_channels"]
        self.encoder = Encoder(mc["effnet_variant"])
        self.camencode = CamEncode(self.depth_bins, self.cam_c)
        self.bevencode = BevEncode(self.cam_c * self.nx[2], mc["seg_classes"])
        h = ((CROP_X[1] - CROP_X[0] - 1) // 2 + 1) // POST_POOL[0]
        w = (CROP_Y[1] - CROP_Y[0]) // POST_POOL[1]
        self.sceneunder = SceneUnder(512)
        self.bevpost = BevPost(mc["seg_classes"], 8)
        self.embeder_f1 = EmbedderConv(256, 32)
        self.embeder_f2 = EmbedderFlat(40 * h * w, 40)
        self.embeder_lr1 = EmbedderConv(256, 32)
        self.embeder_lr2 = EmbedderFlat(40 * h * w, 40)
        self.predictorf1 = Predictor(40, 4)
        self.predictorf2 = Predictor(40, 4)
        self.predictorlr = Predictor(40, 1)

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans):
        b, n = imgs.shape[:2]
        cam = self.encoder(imgs.reshape(b * n, *imgs.shape[2:]))
        depth, feat = self.camencode(cam)
        fh, fw = feat.shape[-2:]
        fr = torch.tensor(self.frustum_np, device=imgs.device)
        idx, valid = voxel_indices(geometry(fr, rots, trans, intrins, post_rots, post_trans),
                                   self.dx, self.bx, self.nx)
        bev = self.bevencode(lift_splat(feat.view(b, n, self.cam_c, fh, fw),
                                        depth.view(b, n, self.depth_bins, fh, fw), idx, valid,
                                        self.nx))
        crop = bev.detach()[:, :, CROP_X[0]:CROP_X[1], CROP_Y[0]:CROP_Y[1]]
        post = self.bevpost(crop)
        y = self.sceneunder(cam)
        y = y.view(b, -1, *y.shape[1:])

        def side(c):
            e = torch.cat([self.embeder_lr1(c), post], dim=1)
            return self.predictorlr(self.embeder_lr2(e))

        yf = self.embeder_f2(torch.cat([self.embeder_f1(y[:, 1]), post], dim=1))
        act = self.predictorf2(yf)
        desc = torch.cat([self.predictorf1(yf), side(y[:, 0]), side(y[:, 3]), side(y[:, 2]),
                          side(y[:, 5])], dim=1)
        return bev, act, desc
