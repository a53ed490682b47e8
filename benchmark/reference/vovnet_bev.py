"""Plain reference of `VoVNetBEVTransformer`, the flagship: timm's
ese_vovnet trunk, LSS v1/v2 depth, lift-splat, the deformable BEV
transformer with its FFN/LayerNorm tail and 3-conv seg head, and the TXT
branch (feature pyramid, ASPP, camera attention, BEV-camera fusion, the
unified predictor). Module and parameter names are the port's, so one state
dict loads into both. Every kernel is its plain composite (`common.py`);
training and eval take the same op-by-op path. At LSS v1 the port runs
VoVNet's stage 4 in training only for its batch-norm running statistics,
which no compared number reads: it is left out here.

Layer equations: the original repo's `src/model_vovnet_transformer.py`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import (ConvBNReLU, ConvBnAct, SceneUnder, conv2d, conv_bn, deformable_sample,
                     frustum, geometry, grid_sizes, layer_norm, lift_splat, linear,
                     multi_head_attention, no_cudnn, resize_bilinear, sine_position_embedding,
                     voxel_indices)

# (stem_chs, stage_conv_chs, stage_out_chs, layer_per_block, block_per_stage)
TIMM_CONFIGS = {
    "vovnet39": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 1, 2, 2)),
    "vovnet57": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 1, 4, 3)),
    "vovnet99": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 3, 9, 3)),
}


class EffectiveSE(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.fc = nn.Conv2d(ch, ch, 1, bias=True)

    def forward(self, x):
        s = conv_bn(x.mean(dim=(2, 3), keepdim=True), self.fc)
        return x * torch.clamp(s / 6.0 + 0.5, 0.0, 1.0)


class OsaBlock(nn.Module):
    def __init__(self, cin, mid, cout, layers, residual):
        super().__init__()
        self.residual = residual
        self.conv_mid = nn.ModuleList(ConvBnAct(cin if i == 0 else mid, mid, 3)
                                      for i in range(layers))
        self.conv_concat = ConvBnAct(cin + layers * mid, cout, 1)
        self.attn = EffectiveSE(cout)

    def forward(self, x):
        identity, outs = x, [x]
        for m in self.conv_mid:
            x = m(x)
            outs.append(x)
        x = self.attn(self.conv_concat(torch.cat(outs, dim=1)))
        return x + identity if self.residual else x


class OsaStage(nn.Module):
    def __init__(self, blocks, pool):
        super().__init__()
        self.pool = pool
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        if self.pool:
            x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for b in self.blocks:
            x = b(x)
        return x


class VoVNetV2(nn.Module):
    def __init__(self, model_name):
        super().__init__()
        stem_chs, conv_chs, out_chs, layers, blocks = TIMM_CONFIGS[model_name]
        stem, cin = [], 3
        for ch, s in zip(stem_chs, (2, 1, 2)):
            stem.append(ConvBnAct(cin, ch, 3, s))
            cin = ch
        self.stem = nn.ModuleList(stem)
        stages = []
        for s in range(4):
            stages.append(OsaStage([OsaBlock(cin if b == 0 else out_chs[s], conv_chs[s],
                                             out_chs[s], layers, residual=b > 0)
                                    for b in range(blocks[s])], pool=s > 0))
            cin = out_chs[s]
        self.stages = nn.ModuleList(stages)

    def forward(self, x, with_c4):
        for m in self.stem:
            x = m(x)
        for stage in self.stages[:3]:
            x = stage(x)
        return x, (self.stages[3](x) if with_c4 else None)


class VoVNetBackbone(nn.Module):
    def __init__(self, model_name):
        super().__init__()
        self.backbone = VoVNetV2(model_name)

    def forward(self, x, with_c4):
        return self.backbone(x, with_c4)


class _DepthHead(nn.Sequential):
    def __init__(self, cin, depth_bins):
        super().__init__(conv2d(cin, 256, 3), nn.BatchNorm2d(256), nn.ReLU(inplace=True),
                         conv2d(256, depth_bins, 1))

    def forward(self, x):
        return conv_bn(conv_bn(x, self[0], self[1], relu=True), self[3])


class MultiScaleDepthNet(nn.Module):
    def __init__(self, depth_bins, c3=768, c4=1024):
        super().__init__()
        self.depth_c3 = _DepthHead(c3, depth_bins)
        self.depth_c4 = _DepthHead(c4, depth_bins)
        self.fusion = ConvBNReLU(2 * depth_bins, depth_bins, 1)

    def forward(self, c3, c4):
        d3 = self.depth_c3(c3)
        d4 = resize_bilinear(self.depth_c4(c4), d3.shape[-2:], align_corners=False)
        return torch.softmax(self.fusion(torch.cat([d3, d4], dim=1)), dim=1)


class StandardDepthNet(nn.Module):
    def __init__(self, depth_bins, c3=768):
        super().__init__()
        self.depth_head = _DepthHead(c3, depth_bins)

    def forward(self, c3, c4=None):
        return torch.softmax(self.depth_head(c3), dim=1)


class CamEncodeV2(nn.Module):
    def __init__(self, cin, out_features):
        super().__init__()
        self.feat_proj = conv2d(cin, out_features, 1)

    def forward(self, x):
        return conv_bn(x, self.feat_proj)


class DeformableAttention(nn.Module):
    def __init__(self, d_model=256, n_heads=8, n_points=8):
        super().__init__()
        self.n_heads, self.n_points = n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, value, ref):
        b, n, c = query.shape
        h = w = int(math.sqrt(n))
        nh, npts = self.n_heads, self.n_points
        off = linear(query, self.sampling_offsets).view(b, n, nh, npts, 2).permute(0, 2, 3, 4, 1)
        attn = linear(query, self.attention_weights).view(b, n, nh, npts).permute(0, 2, 3, 1)
        attn = torch.softmax(attn, dim=2)
        lx = torch.clamp(ref[:, 0][None, None, None] + off[:, :, :, 0] / h, 0.0, 1.0)
        ly = torch.clamp(ref[:, 1][None, None, None] + off[:, :, :, 1] / h, 0.0, 1.0)
        v = linear(value, self.value_proj).view(b, n, nh, c // nh).permute(0, 2, 1, 3)
        out = deformable_sample(v.reshape(b * nh, n, c // nh), lx.reshape(b * nh, npts, n),
                                ly.reshape(b * nh, npts, n), attn.reshape(b * nh, npts, n), h, w)
        out = out.view(b, nh, n, c // nh).permute(0, 2, 1, 3).reshape(b, n, c)
        return linear(out, self.output_proj)


class TransformerEncoderLayer(nn.Module):
    """Deformable self-attention, then LN -> GELU FFN -> residual -> LN,
    dropout 0.1 at three places while training."""

    def __init__(self, d_model=256, n_heads=8, dim_feedforward=1024, ln_eps=1e-6):
        super().__init__()
        self.self_attn = DeformableAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=ln_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=ln_eps)
        self.dropout = nn.Dropout(0.1)
        self.dropout1 = nn.Dropout(0.1)
        self.dropout2 = nn.Dropout(0.1)

    def forward(self, src, pos, ref):
        u = src + self.dropout1(self.self_attn(src + pos, src, ref))
        s = layer_norm(u, self.norm1)
        y = self.dropout(F.gelu(linear(s, self.linear1)))
        return layer_norm(s + self.dropout2(linear(y, self.linear2)), self.norm2)


class LightweightBEVTransformer(nn.Module):
    def __init__(self, d_model=256, n_heads=8, dim_feedforward=1024, ln_eps=1e-6):
        super().__init__()
        self.d_model = d_model
        self.encoder = TransformerEncoderLayer(d_model, n_heads, dim_feedforward, ln_eps)

    def forward(self, x):
        b, c, h, w = x.shape
        pos = torch.tensor(sine_position_embedding(h, w, self.d_model // 2),
                           device=x.device).reshape(1, h * w, -1)
        ys, xs = np.linspace(0, 1, h, dtype=np.float32), np.linspace(0, 1, w, dtype=np.float32)
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        ref = torch.tensor(np.stack([gx, gy], axis=-1).reshape(h * w, 2), device=x.device)
        return self.encoder(x.permute(0, 2, 3, 1).reshape(b, h * w, c), pos, ref)


class BEVEncoderTransformer(nn.Module):
    def __init__(self, cin, out_features, ln_eps):
        super().__init__()
        self.compress = ConvBNReLU(cin, 256, 1)
        self.transformer = LightweightBEVTransformer(256, 8, 1024, ln_eps)
        self.seg_head = nn.Sequential(
            conv2d(256, 128, 3), nn.BatchNorm2d(128), nn.ReLU(inplace=True),
            conv2d(128, 64, 3), nn.BatchNorm2d(64), nn.ReLU(inplace=True),
            conv2d(64, out_features, 1))

    def forward(self, x):
        x = self.compress(x)
        b, _, h, w = x.shape
        refined = self.transformer(x).view(b, h, w, -1).permute(0, 3, 1, 2)
        s = self.seg_head
        with no_cudnn(refined):
            y = conv_bn(refined, s[0], s[1], relu=True)
        y = conv_bn(y, s[3], s[4], relu=True)
        return conv_bn(y, s[6]), refined


class AdaptiveFeaturePyramid(nn.Module):
    def __init__(self, cin=768, out_features=256):
        super().__init__()
        self.scale1 = ConvBNReLU(cin, out_features, 3)
        self.scale2 = ConvBNReLU(cin, out_features, 3, dilation=2)
        self.fusion = ConvBNReLU(2 * out_features, out_features, 1)

    def forward(self, x):
        return self.fusion(torch.cat([self.scale1(x), self.scale2(x)], dim=1))


class LightweightCameraTransformer(nn.Module):
    def __init__(self, d_model=256, n_heads=4, n_cameras=6, ln_eps=1e-6):
        super().__init__()
        self.cam_embed = nn.Embedding(n_cameras, d_model)
        self.self_attn = nn.MultiheadAttention(d_model, n_heads, dropout=0.1, batch_first=True)
        self.norm1 = nn.LayerNorm(d_model, eps=ln_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=ln_eps)
        self.ffn = nn.Sequential(nn.Linear(d_model, 2 * d_model), nn.GELU(), nn.Dropout(0.1),
                                 nn.Linear(2 * d_model, d_model))

    def forward(self, x, camera_ids):
        x = x + self.cam_embed(camera_ids)
        x = layer_norm(x + multi_head_attention(x, x, x, self.self_attn), self.norm1)
        y = linear(self.ffn[2](F.gelu(linear(x, self.ffn[0]))), self.ffn[3])
        return layer_norm(x + y, self.norm2)


class BEVCameraFusion(nn.Module):
    def __init__(self, d_model=256, n_heads=4, ln_eps=1e-6):
        super().__init__()
        self.cross_attn = nn.MultiheadAttention(d_model, n_heads, dropout=0.1, batch_first=True)
        self.norm = nn.LayerNorm(d_model, eps=ln_eps)

    def forward(self, camera_feat, bev_feat):
        bev_tok = bev_feat.mean(dim=(2, 3))[:, None, :]
        fused = multi_head_attention(camera_feat, bev_tok, bev_tok, self.cross_attn)
        return layer_norm(camera_feat + fused, self.norm)


class UnifiedPredictor(nn.Module):
    def __init__(self, num_action_classes, num_desc_classes, n_cameras, ln_eps):
        super().__init__()
        self.camera_weights = nn.Parameter(torch.empty(n_cameras))
        self.encoder = nn.Sequential(
            nn.Linear(256, 512), nn.LayerNorm(512, eps=ln_eps), nn.GELU(), nn.Dropout(0.1),
            nn.Linear(512, 256), nn.LayerNorm(256, eps=ln_eps), nn.GELU())
        self.action_head = nn.Linear(256, num_action_classes)
        self.desc_head = nn.Linear(256, num_desc_classes)

    def forward(self, camera_features):
        n = camera_features.shape[1]
        w = torch.softmax(self.camera_weights, dim=0).view(1, n, 1)
        x = (camera_features * w).sum(dim=1)
        e = self.encoder
        x = e[3](F.gelu(layer_norm(linear(x, e[0]), e[1])))
        x = F.gelu(layer_norm(linear(x, e[4]), e[5]))
        return linear(x, self.action_head), linear(x, self.desc_head)


class VoVNetBEVTransformer(nn.Module):
    """forward(imgs (B, N, 3, H, W), rots, trans, intrins, post_rots,
    post_trans) -> (bev (B, 4, X, Y), action (B, 4), desc (B, 8))."""

    def __init__(self, cfg: dict):
        super().__init__()
        mc, grid, aug = cfg["model"], cfg["grid"], cfg["aug"]
        self.lss_version = mc["lss_version"]
        self.dx, self.bx, self.nx = grid_sizes(grid)
        self.frustum_np = frustum(aug["final_dim"], grid["dbound"], mc["downsample"])
        self.depth_bins = self.frustum_np.shape[0]
        self.cam_c = mc["v2_cam_channels"]
        self.n_cameras = aug["ncams"]
        eps = mc["ln_eps"]
        self.backbone = VoVNetBackbone(mc["vovnet_type"])
        self.depth_net = (MultiScaleDepthNet(self.depth_bins) if self.lss_version == "v2"
                          else StandardDepthNet(self.depth_bins))
        self.cam_encode = CamEncodeV2(768, self.cam_c)
        self.bev_encoder = BEVEncoderTransformer(self.cam_c * self.nx[2], mc["seg_classes"], eps)
        self.feature_pyramid = AdaptiveFeaturePyramid(768, 256)
        self.sceneunder = SceneUnder(256)
        self.camera_transformer = (LightweightCameraTransformer(n_cameras=self.n_cameras, ln_eps=eps)
                                   if mc["use_camera_attn"] else None)
        self.bev_fusion = BEVCameraFusion(ln_eps=eps) if mc["use_cross_attn"] else None
        self.unified_predictor = UnifiedPredictor(mc["num_action_classes"],
                                                  mc["num_desc_classes"], self.n_cameras, eps)

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans):
        b, n = imgs.shape[:2]
        c3, c4 = self.backbone(imgs.reshape(b * n, *imgs.shape[2:]), self.lss_version == "v2")
        depth = self.depth_net(c3, c4)
        feat = self.cam_encode(c3)
        fh, fw = feat.shape[-2:]
        fr = torch.tensor(self.frustum_np, device=imgs.device)
        idx, valid = voxel_indices(geometry(fr, rots, trans, intrins, post_rots, post_trans),
                                   self.dx, self.bx, self.nx)
        bev = lift_splat(feat.view(b, n, self.cam_c, fh, fw),
                         depth.view(b, n, self.depth_bins, fh, fw), idx, valid, self.nx)
        bev_seg, refined = self.bev_encoder(bev)
        scene = self.sceneunder(self.feature_pyramid(c3)).mean(dim=(2, 3))
        x = scene.view(-1, n, scene.shape[-1])
        if self.camera_transformer is not None:
            x = self.camera_transformer(x, torch.arange(n, device=x.device).expand(x.shape[0], n))
        if self.bev_fusion is not None:
            x = self.bev_fusion(x, refined)
        action, desc = self.unified_predictor(x)
        return bev_seg, action, desc
