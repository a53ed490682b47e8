"""Plain PyTorch building blocks of the benchmark's reference models.

Frozen copies of the port's shared layers (conv + batch norm, the BEV grid,
the frustum and its geometry, lift-splat, deformable sampling, attention),
written with PyTorch calls alone: every hand-written kernel of the port is
replaced by its plain composite. Lift-splat is a gather, a product and
`index_add_`; deformable sampling is `F.grid_sample` and a weighted sum; the
bilinear resize is `F.interpolate`. Batch norm runs after the conv in both
modes (the port folds it into the conv in eval). Nothing here imports the
port, and nothing runs at import time.

Every function works on the meta device as well, so that the benchmark can
count a step's operations without running it.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextmanager
def no_cudnn(x: torch.Tensor):
    """cuDNN off for a float32 conv on a card, where with TF32 off its
    heuristic picks FFT tiling many times slower than PyTorch's own conv;
    the port does the same for the same convs."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        yield
        return
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d | None = None, relu: bool = False):
    """conv, then batch norm (batch statistics in training, running ones in
    eval), then ReLU."""
    y = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding, conv.dilation, conv.groups)
    if bn is not None:
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=bn.training, momentum=bn.momentum, eps=bn.eps)
    return F.relu(y) if relu else y


def conv2d(cin, cout, k, dilation=1, stride=1, bias=True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k - 1) // 2,
                     dilation=dilation, bias=bias)


def linear(x, m: nn.Linear):
    return F.linear(x, m.weight, m.bias)


def layer_norm(x, m: nn.LayerNorm):
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, m.eps)


def resize_bilinear(x, out_hw, align_corners: bool):
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin, cout, k, dilation=1, bias=True):
        super().__init__(conv2d(cin, cout, k, dilation, bias=bias), nn.BatchNorm2d(cout),
                         nn.ReLU(inplace=True))

    def forward(self, x):
        return conv_bn(x, self[0], self[1], relu=True)


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.conv = conv2d(cin, cout, k, stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return conv_bn(x, self.conv, self.bn, relu=True)


class Up(nn.Module):
    """Resize x1 to x2's size (align_corners=True), concat [x2, x1], two
    conv-BN-ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(
            conv2d(cin, cout, 3, bias=False), nn.BatchNorm2d(cout), nn.ReLU(inplace=True),
            conv2d(cout, cout, 3, bias=False), nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x1, x2):
        x = torch.cat([x2, resize_bilinear(x1, x2.shape[-2:], True)], dim=1)
        x = conv_bn(x, self.conv[0], self.conv[1], relu=True)
        return conv_bn(x, self.conv[3], self.conv[4], relu=True)


class ASPPPooling(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(nn.AdaptiveAvgPool2d(1), conv2d(cin, cout, 1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        p = conv_bn(x.mean(dim=(2, 3), keepdim=True), self[1], self[2], relu=True)
        return p.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    """torchvision's DeepLab ASPP, dropout 0.5 after the projection."""

    def __init__(self, cin, rates, features=256):
        super().__init__()
        convs = [ConvBNReLU(cin, features, 1, bias=False)]
        convs += [ConvBNReLU(cin, features, 3, dilation=r, bias=False) for r in rates]
        convs.append(ASPPPooling(cin, features))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            conv2d(features * len(convs), features, 1, bias=False), nn.BatchNorm2d(features),
            nn.ReLU(inplace=True), nn.Dropout(0.5))

    def forward(self, x):
        y = torch.cat([m(x) for m in self.convs], dim=1)
        return self.project[3](conv_bn(y, self.project[0], self.project[1], relu=True))


class SceneUnder(nn.Sequential):
    def __init__(self, cin=256):
        super().__init__(ASPP(cin, (12, 24, 36)))


def multi_head_attention(q, k, v, m: nn.MultiheadAttention):
    """Batch-first attention with m's packed projections; dropout on the
    attention weights while m is training."""
    b, nq, c = q.shape
    nk, nh = k.shape[1], m.num_heads
    dh = c // nh
    wq, wk, wv = m.in_proj_weight.chunk(3)
    bq, bk, bv = m.in_proj_bias.chunk(3)
    qh = F.linear(q, wq, bq).view(b, nq, nh, dh)
    kh = F.linear(k, wk, bk).view(b, nk, nh, dh)
    vh = F.linear(v, wv, bv).view(b, nk, nh, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / (dh ** 0.5)
    attn = F.dropout(torch.softmax(logits, dim=-1), m.dropout, m.training)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, nq, c)
    return linear(out, m.out_proj)


# ---- the BEV grid and the camera frustum

def grid_sizes(grid):
    """(dx, bx, nx) of the grid bounds {xbound, ybound, zbound}, each (lo,
    hi, step): voxel size, first voxel's centre, voxel counts."""
    bounds = (grid["xbound"], grid["ybound"], grid["zbound"])
    dx = [float(np.float32(b[2])) for b in bounds]
    bx = [float(np.float32(b[0] + b[2] / 2.0)) for b in bounds]
    nx = [int((b[1] - b[0]) / b[2]) for b in bounds]
    return dx, bx, nx


def frustum(final_dim, dbound, downsample: int) -> np.ndarray:
    """(D, fH, fW, 3) float32: (x pixel, y pixel, depth) of every frustum
    point on the augmented image."""
    h, w = final_dim
    fh, fw = h // downsample, w // downsample
    ds = np.arange(*dbound, dtype=np.float32)
    d = ds.shape[0]
    depth = np.broadcast_to(ds[:, None, None], (d, fh, fw))
    xs = np.broadcast_to(np.linspace(0, w - 1, fw, dtype=np.float32)[None, None, :], (d, fh, fw))
    ys = np.broadcast_to(np.linspace(0, h - 1, fh, dtype=np.float32)[None, :, None], (d, fh, fw))
    return np.stack([xs, ys, depth], axis=-1).astype(np.float32)


def invert_3x3(m):
    """Batched closed-form 3x3 inverse (adjugate over determinant)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a, co_b, co_c = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def geometry(frustum_t, rots, trans, intrins, post_rots, post_trans):
    """Ego-frame (x, y, z) of every frustum point, (B, N, D, fH, fW, 3):
    undo the augmentation, lift (u, v, d) to (u d, v d, d), rotate by rot @
    K^-1 and translate. The 3x3 products are written as multiply-and-sum,
    so no TF32 unit rounds them."""
    def matvec(m, p):
        return (m[:, :, None, None, None] * p[..., None, :]).sum(-1)

    pts = frustum_t[None, None] - post_trans[:, :, None, None, None, :]
    pts = matvec(invert_3x3(post_rots), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = (rots[..., :, :, None] * invert_3x3(intrins)[..., None, :, :]).sum(-2)
    return matvec(combine, pts) + trans[:, :, None, None, None, :]


def voxel_indices(geom, dx, bx, nx):
    """int32 voxel coordinates (truncated toward zero, as the original's
    `.long()`) and whether each lies inside the grid."""
    dxt = torch.tensor(dx, dtype=torch.float32, device=geom.device)
    bxt = torch.tensor(bx, dtype=torch.float32, device=geom.device)
    nxt = torch.tensor(nx, dtype=torch.int32, device=geom.device)
    idx = ((geom - (bxt - dxt / 2.0)) / dxt).to(torch.int32)
    return idx, ((idx >= 0) & (idx < nxt)).all(dim=-1)


def lift_splat(feat, depth, idx, valid, nx):
    """feat (B, N, C, fH, fW), depth (B, N, D, fH, fW) -> (B, Z*C, X, Y):
    every frustum point's feature times its depth weight, summed into its
    voxel by `index_add_`; points outside the grid add nothing."""
    b, n, d, fh, fw = depth.shape
    c = feat.shape[2]
    x, y, z = nx
    vals = depth[:, :, :, None] * feat[:, :, None]  # (B, N, D, C, fH, fW)
    vals = vals.permute(0, 1, 2, 4, 5, 3) * valid[..., None].to(vals.dtype)
    seg = (idx[..., 2] * x + idx[..., 0]) * y + idx[..., 1]
    seg = torch.where(valid, seg, torch.zeros_like(seg)).long()
    seg = seg + (torch.arange(b, device=seg.device) * (z * x * y)).view(b, 1, 1, 1, 1)
    out = torch.zeros(b * z * x * y, c, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, seg.reshape(-1), vals.reshape(-1, c))
    return out.view(b, z, x, y, c).permute(0, 1, 4, 2, 3).reshape(b, z * c, x, y)


def deformable_sample(v, lx, ly, attn, h: int, w: int):
    """v (BH, H*W, dh), lx/ly/attn (BH, npts, N) -> (BH, N, dh): each query's
    attention-weighted bilinear samples of v (align_corners=False, zero
    padding), by `F.grid_sample` at 2 (lx, ly) - 1."""
    bh, _, dh = v.shape
    vimg = v.transpose(1, 2).reshape(bh, dh, h, w)
    grid = torch.stack([lx, ly], -1).permute(0, 2, 1, 3) * 2 - 1  # (BH, N, npts, 2)
    s = F.grid_sample(vimg, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return (s * attn.permute(0, 2, 1)[:, None]).sum(-1).transpose(1, 2)


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0) -> np.ndarray:
    """(H, W, 2 num_pos_feats), channels [pos_y, pos_x]."""
    scale = 2 * math.pi
    y = np.arange(h, dtype=np.float32) / max(h - 1, 1) * scale
    x = np.arange(w, dtype=np.float32) / max(w - 1, 1) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x, pos_y = x[:, None] / dim_t, y[:, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, 0::2]), np.cos(pos_x[:, 1::2])], axis=2).reshape(w, -1)
    pos_y = np.stack([np.sin(pos_y[:, 0::2]), np.cos(pos_y[:, 1::2])], axis=2).reshape(h, -1)
    pos_y = np.broadcast_to(pos_y[:, None, :], (h, w, num_pos_feats))
    pos_x = np.broadcast_to(pos_x[None, :, :], (h, w, num_pos_feats))
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)
