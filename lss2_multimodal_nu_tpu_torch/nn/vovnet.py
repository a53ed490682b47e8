"""VoVNet backbones, NCHW, counterparts of the JAX package's `nn/vovnet.py`.

* `VoVNetV2`, the timm `ese_vovnet` architecture the models use. State-dict
  keys follow timm: `stem.{i}.conv/bn`,
  `stages.{s}.blocks.{b}.conv_mid.{i}.conv/bn`, `.conv_concat.conv/bn`,
  `.attn.fc`.
* `VoVNetSimple`, the original repo's from-scratch backbone, which no model
  uses: a 256-channel stem, OSA convs at the stage's output width, c3 and c4
  both at stride 16. Its keys are the original's: the stem one Sequential
  (conv/bn at 0/1, 3/4, 6/7), `stage{s}.{b}.layers.{i}.0/.1`,
  `.concat_conv.0/.1`, `.ese.fc`.

The one-shot aggregation is one 1x1 conv over the concatenation.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

import torch.nn.functional as F

from .layers import (ConvBNReLU, ConvBnAct, conv2d, conv_bn, global_avg_pool, hard_sigmoid,
                     max_pool_ceil)

# (stem_chs, stage_conv_chs, stage_out_chs, layer_per_block, block_per_stage)
TIMM_CONFIGS = {
    "vovnet39": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 1, 2, 2)),
    "vovnet57": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 1, 4, 3)),
    "vovnet99": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 3, 9, 3)),
}


class EffectiveSE(nn.Module):
    """Mean pool -> 1x1 conv with bias -> hard sigmoid gate."""

    def __init__(self, ch: int):
        super().__init__()
        self.fc = nn.Conv2d(ch, ch, 1, bias=True)

    def forward(self, x):
        return x * hard_sigmoid(conv_bn(global_avg_pool(x), self.fc))


class OsaBlock(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, layers: int, residual: bool):
        super().__init__()
        self.residual = residual
        self.conv_mid = nn.ModuleList(
            ConvBnAct(cin if i == 0 else mid, mid, 3) for i in range(layers)
        )
        self.conv_concat = ConvBnAct(cin + layers * mid, cout, 1)
        self.attn = EffectiveSE(cout)

    def forward(self, x):
        identity = x
        outs = [x]
        for m in self.conv_mid:
            x = m(x)
            outs.append(x)
        x = self.attn(self.conv_concat(torch.cat(outs, dim=1)))
        if self.residual:
            x = x + identity
        return x


class OsaStage(nn.Module):
    def __init__(self, blocks, pool: bool):
        super().__init__()
        self.pool = pool
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        if self.pool:
            x = max_pool_ceil(x)
        for b in self.blocks:
            x = b(x)
        return x


class VoVNetV2(nn.Module):
    """Returns {'c3': stage-3 output at stride 16, 'c4': stage-4 output at
    stride 32}; with `with_c4=False` it returns c3 alone, and stage 4 runs
    only in training, without autograd, for its batch-norm running
    statistics: the JAX package and the original repo update them from the
    stage that nothing reads (ROADMAP fault 7)."""

    def __init__(self, model_name: str = "vovnet39"):
        super().__init__()
        stem_chs, conv_chs, out_chs, layers, blocks = TIMM_CONFIGS[model_name]
        stem, cin = [], 3
        for ch, s in zip(stem_chs, (2, 1, 2)):
            stem.append(ConvBnAct(cin, ch, 3, s))
            cin = ch
        self.stem = nn.ModuleList(stem)
        stages = []
        for s in range(4):
            stages.append(OsaStage(
                [OsaBlock(cin if b == 0 else out_chs[s], conv_chs[s], out_chs[s], layers,
                          residual=b > 0) for b in range(blocks[s])],
                pool=s > 0,
            ))
            cin = out_chs[s]
        self.stages = nn.ModuleList(stages)

    def forward(self, x, with_c4: bool = True) -> Dict[str, torch.Tensor]:
        for m in self.stem:
            x = m(x)
        for stage in self.stages[:3]:
            x = stage(x)
        feats = {"c3": x}
        if with_c4:
            feats["c4"] = self.stages[3](x)
        elif self.training:
            with torch.no_grad():
                self.stages[3](x)
        return feats


class VoVNetBackbone(nn.Module):
    """The original model's wrapper: the timm trunk sits at `.backbone`."""

    def __init__(self, model_name: str = "vovnet39"):
        super().__init__()
        self.backbone = VoVNetV2(model_name)

    def forward(self, x, with_c4: bool = True):
        return self.backbone(x, with_c4)


class OsaBlockSimple(nn.Module):
    """The original's OSA module: 5 conv-BN-ReLU at the block's width, the
    concatenation through a 1x1 conv-BN-ReLU, eSE, and with `residual` (every
    block but a stage's first) the identity added."""

    def __init__(self, cin: int, ch: int, residual: bool, layers: int = 5):
        super().__init__()
        self.residual = residual
        self.layers = nn.ModuleList(
            ConvBNReLU(cin if i == 0 else ch, ch, 3, bias=False) for i in range(layers))
        self.concat_conv = ConvBNReLU(cin + layers * ch, ch, 1, bias=False)
        self.ese = EffectiveSE(ch)

    def forward(self, x):
        identity = x
        outs = [x]
        for m in self.layers:
            x = m(x)
            outs.append(x)
        x = self.ese(self.concat_conv(torch.cat(outs, dim=1)))
        return x + identity if self.residual else x


class VoVNetSimple(nn.Module):
    """The original repo's from-scratch backbone (JAX `nn/vovnet.py:149`):
    stem 128 (stride 2), 128, 256; a 3x3 / stride-2 pool with padding 1
    before each of stages 1-3; stage 4 has no pool, so c3 and c4 are both at
    stride 16. Returns {'c3', 'c4'}."""

    # (blocks, out_ch) per stage
    STAGE_CONFIGS = {
        "vovnet39": ((1, 256), (1, 512), (1, 768), (1, 1024)),
        "vovnet57": ((1, 256), (1, 512), (2, 768), (2, 1024)),
        "vovnet99": ((1, 256), (1, 512), (2, 768), (2, 1024)),
    }

    def __init__(self, model_name: str = "vovnet57"):
        super().__init__()
        self.stem = nn.Sequential(
            conv2d(3, 128, 3, stride=2, bias=False), nn.BatchNorm2d(128), nn.ReLU(inplace=True),
            conv2d(128, 128, 3, bias=False), nn.BatchNorm2d(128), nn.ReLU(inplace=True),
            conv2d(128, 256, 3, bias=False), nn.BatchNorm2d(256), nn.ReLU(inplace=True))
        cin = 256
        for s, (blocks, ch) in enumerate(self.STAGE_CONFIGS[model_name]):
            setattr(self, f"stage{s + 1}", nn.ModuleList(
                OsaBlockSimple(cin if b == 0 else ch, ch, residual=b > 0) for b in range(blocks)))
            cin = ch

    def forward(self, x) -> Dict[str, torch.Tensor]:
        for i in (0, 3, 6):
            x = conv_bn(x, self.stem[i], self.stem[i + 1], relu=True)
        for s in range(1, 5):
            if s < 4:
                x = F.max_pool2d(x, 3, 2, padding=1)
            for block in getattr(self, f"stage{s}"):
                x = block(x)
            if s == 3:
                c3 = x
        return {"c3": c3, "c4": x}
