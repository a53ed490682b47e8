"""BEV encoder and the TXT-branch heads, counterparts of the JAX package's
`nn/fusion.py`. Key names follow the original model: the seg head is one
flat `seg_head` Sequential (indices 0/1/3/4/6), attention modules are
`nn.MultiheadAttention` with a packed `in_proj`. Dropout is active while a
module is training: the Dropout modules and each attention's `dropout`."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.seg_head import fold_conv_bn, fused_seg_head
from .layers import ConvBNReLU, conv2d, conv_bn, cudnn_off_for_float32, layer_norm, linear
from .transformer import LightweightBEVTransformer


def multi_head_attention(q, k, v, m: nn.MultiheadAttention):
    """Batch-first attention with m's packed projections, in q's dtype;
    m's dropout on the attention weights while m is training."""
    b, nq, c = q.shape
    nk = k.shape[1]
    nh = m.num_heads
    dh = c // nh
    wq, wk, wv = m.in_proj_weight.to(q.dtype).chunk(3)
    bq, bk, bv = m.in_proj_bias.to(q.dtype).chunk(3)
    qh = F.linear(q, wq, bq).view(b, nq, nh, dh)
    kh = F.linear(k, wk, bk).view(b, nk, nh, dh)
    vh = F.linear(v, wv, bv).view(b, nk, nh, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / (dh ** 0.5)
    attn = F.dropout(torch.softmax(logits, dim=-1), m.dropout, m.training)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, nq, c)
    return linear(out, m.out_proj)


class BEVEncoderTransformer(nn.Module):
    """Compress Z*C -> 256, transformer refine, 3-conv seg head (kernel 5 in
    eval; conv -> train BN -> ReLU twice, then the 1x1 conv, in training).
    Returns (seg logits (B, out, X, Y), refined features (B, 256, X, Y)).

    In float32 training on the card the seg head's first conv (3x3 256 ->
    128 at 200x200, on the tokens' permuted view) runs its forward without
    cuDNN: with TF32 off, cuDNN's heuristic takes FFT tiling, 17.5-17.7 ms
    at B=8 and 265-454 ms at B=12 over two runs, against 7.3 and 11.0 ms for
    PyTorch's im2col and cuBLAS, 6e-7 from float64 alike; its backward,
    which picks its backend when it runs, stays with cuDNN, faster there
    (8.7 against 18.1 ms at B=8). The second conv is faster with cuDNN
    (`scripts/port_seg_head_train_conv.py`, NVIDIA H100 80GB HBM3, 700.00
    W)."""

    def __init__(self, cin: int = 128, out_features: int = 4, ln_eps: float = 1e-6):
        super().__init__()
        self.compress = ConvBNReLU(cin, 256, 1)
        self.transformer = LightweightBEVTransformer(256, 8, 1024, ln_eps)
        self.seg_head = nn.Sequential(
            conv2d(256, 128, 3), nn.BatchNorm2d(128), nn.ReLU(inplace=True),
            conv2d(128, 64, 3), nn.BatchNorm2d(64), nn.ReLU(inplace=True),
            conv2d(64, out_features, 1),
        )

    def folded_seg_head(self):
        """(w0, b0, w1, b1, w2, b2): BN folded, HWIO kernels, w2 (64, out)."""
        hwio = lambda conv: conv.weight.permute(2, 3, 1, 0)
        folded = []
        for conv, bn in ((self.seg_head[0], self.seg_head[1]),
                         (self.seg_head[3], self.seg_head[4])):
            folded += fold_conv_bn(hwio(conv), conv.bias, bn.weight, bn.bias,
                                   bn.running_mean, bn.running_var, bn.eps)
        head = self.seg_head[6]
        return (*folded, head.weight[:, :, 0, 0].t(), head.bias)

    def forward(self, x):
        x = self.compress(x)
        b, _, h, w = x.shape
        tokens = self.transformer(x)  # (B, h*w, 256)
        refined = tokens.view(b, h, w, -1).permute(0, 3, 1, 2)
        if self.training:
            s = self.seg_head
            with cudnn_off_for_float32(refined):
                y = conv_bn(refined, s[0], s[1], relu=True)
            y = conv_bn(y, s[3], s[4], relu=True)
            return conv_bn(y, s[6]), refined
        seg = fused_seg_head(tokens, *self.folded_seg_head(), h, w).to(x.dtype)
        return seg, refined


class AdaptiveFeaturePyramid(nn.Module):
    """Parallel 3x3 convs (dilation 1 and 2) + 1x1 fuse."""

    def __init__(self, cin: int = 768, out_features: int = 256):
        super().__init__()
        self.scale1 = ConvBNReLU(cin, out_features, 3)
        self.scale2 = ConvBNReLU(cin, out_features, 3, dilation=2)
        self.fusion = ConvBNReLU(2 * out_features, out_features, 1)

    def forward(self, x):
        return self.fusion(torch.cat([self.scale1(x), self.scale2(x)], dim=1))


class LightweightCameraTransformer(nn.Module):
    """One self-attention layer over the camera tokens (ablations V2/V3)."""

    def __init__(self, d_model: int = 256, n_heads: int = 4, dropout: float = 0.1,
                 n_cameras: int = 6, ln_eps: float = 1e-6):
        super().__init__()
        self.cam_embed = nn.Embedding(n_cameras, d_model)
        self.self_attn = nn.MultiheadAttention(d_model, n_heads, dropout=dropout, batch_first=True)
        self.norm1 = nn.LayerNorm(d_model, eps=ln_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=ln_eps)
        self.ffn = nn.Sequential(nn.Linear(d_model, 2 * d_model), nn.GELU(), nn.Dropout(dropout),
                                 nn.Linear(2 * d_model, d_model))

    def forward(self, x, camera_ids):
        x = x + self.cam_embed(camera_ids).to(x.dtype)
        x = layer_norm(x + multi_head_attention(x, x, x, self.self_attn), self.norm1)
        y = linear(self.ffn[2](F.gelu(linear(x, self.ffn[0]))), self.ffn[3])
        return layer_norm(x + y, self.norm2)


class BEVCameraFusion(nn.Module):
    """Camera tokens cross-attend to the pooled BEV token (ablation V3)."""

    def __init__(self, d_model: int = 256, n_heads: int = 4, ln_eps: float = 1e-6):
        super().__init__()
        self.cross_attn = nn.MultiheadAttention(d_model, n_heads, dropout=0.1, batch_first=True)
        self.norm = nn.LayerNorm(d_model, eps=ln_eps)

    def forward(self, camera_feat, bev_feat):
        bev_tok = bev_feat.mean(dim=(2, 3))[:, None, :]
        fused = multi_head_attention(camera_feat, bev_tok, bev_tok, self.cross_attn)
        return layer_norm(camera_feat + fused, self.norm)


class UnifiedPredictor(nn.Module):
    """Softmax camera weights -> MLP -> action / description heads."""

    def __init__(self, num_action_classes: int = 4, num_desc_classes: int = 8,
                 n_cameras: int = 6, ln_eps: float = 1e-6):
        super().__init__()
        self.camera_weights = nn.Parameter(torch.full((n_cameras,), 1.0 / n_cameras))
        self.encoder = nn.Sequential(
            nn.Linear(256, 512), nn.LayerNorm(512, eps=ln_eps), nn.GELU(), nn.Dropout(0.1),
            nn.Linear(512, 256), nn.LayerNorm(256, eps=ln_eps), nn.GELU(),
        )
        self.action_head = nn.Linear(256, num_action_classes)
        self.desc_head = nn.Linear(256, num_desc_classes)

    def forward(self, camera_features):
        b, n, c = camera_features.shape
        w = torch.softmax(self.camera_weights.to(camera_features.dtype), dim=0).view(1, n, 1)
        x = (camera_features * w).sum(dim=1)
        e = self.encoder
        x = e[3](F.gelu(layer_norm(linear(x, e[0]), e[1])))
        x = F.gelu(layer_norm(linear(x, e[4]), e[5]))
        return linear(x, self.action_head), linear(x, self.desc_head)
