"""Lightweight BEV transformer with deformable attention.

Counterpart of `nn/transformer.py` of the JAX package. Tokens are (B, N, C)
with N = H*W, token h*W + w. The sampling runs through
`ops.deformable_sampling` (kernel 1, and kernel 2 for its backward) and, in
eval, the post-attention tail through `ops.ffn.fused_ffn_ln` (kernel 4).
`output_proj` is a plain Linear on the folded sampling output.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deformable_sampling import deformable_sample_combine_xy
from ..ops.ffn import fused_ffn_ln
from .layers import layer_norm, linear


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0) -> np.ndarray:
    """2D sine embedding over the BEV grid, (H, W, 2*num_pos_feats), channel
    order [pos_y, pos_x]."""
    scale = 2 * math.pi
    y = np.arange(h, dtype=np.float32) / max(h - 1, 1) * scale
    x = np.arange(w, dtype=np.float32) / max(w - 1, 1) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[:, None] / dim_t
    pos_y = y[:, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, 0::2]), np.cos(pos_x[:, 1::2])], axis=2).reshape(w, -1)
    pos_y = np.stack([np.sin(pos_y[:, 0::2]), np.cos(pos_y[:, 1::2])], axis=2).reshape(h, -1)
    pos_y = np.broadcast_to(pos_y[:, None, :], (h, w, num_pos_feats))
    pos_x = np.broadcast_to(pos_x[None, :, :], (h, w, num_pos_feats))
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def _spiral_offset_bias(n_heads: int, n_points: int) -> np.ndarray:
    """Initial offsets: heads spread on a circle, point k pushed out by k+1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, :], (1, n_points, 1))
    for i in range(n_points):
        grid[:, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class DeformableAttention(nn.Module):
    """8 sampled points per head and query instead of full attention."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, n_points: int = 8):
        super().__init__()
        self.n_heads, self.n_points = n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        with torch.no_grad():
            nn.init.zeros_(self.sampling_offsets.weight)
            self.sampling_offsets.bias.copy_(
                torch.from_numpy(_spiral_offset_bias(n_heads, n_points)))
            nn.init.zeros_(self.attention_weights.weight)
            nn.init.zeros_(self.attention_weights.bias)
            for m in (self.value_proj, self.output_proj):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, query, value, reference_points):
        """query, value (B, N, C); reference_points (N, 2) or (B, N, 2) in
        [0, 1], (x, y) order."""
        b, n, c = query.shape
        h = w = int(math.sqrt(n))
        nh, npts = self.n_heads, self.n_points
        dh = c // nh
        # channels ordered (head, point, xy)
        off = linear(query, self.sampling_offsets).view(b, n, nh, npts, 2)
        off = off.permute(0, 2, 3, 4, 1)  # (B, nh, npts, 2, N)
        attn = linear(query, self.attention_weights).view(b, n, nh, npts).permute(0, 2, 3, 1)
        attn = torch.softmax(attn, dim=2)  # over points
        if reference_points.dim() == 2:
            reference_points = reference_points[None]
        refx = reference_points[..., 0][:, None, None, :]
        refy = reference_points[..., 1][:, None, None, :]
        # the original divides both offsets by h
        lx = torch.clamp(refx + off[:, :, :, 0] / h, 0.0, 1.0)
        ly = torch.clamp(refy + off[:, :, :, 1] / h, 0.0, 1.0)
        v = linear(value, self.value_proj).view(b, n, nh, dh).permute(0, 2, 1, 3)
        out = deformable_sample_combine_xy(
            v.reshape(b * nh, n, dh),
            lx.reshape(b * nh, npts, n),
            ly.reshape(b * nh, npts, n),
            attn.reshape(b * nh, npts, n),
            h, w,
        )  # (B*nh, N, dh)
        out = out.view(b, nh, n, dh).permute(0, 2, 1, 3).reshape(b, n, c)
        return linear(out, self.output_proj)


class TransformerEncoderLayer(nn.Module):
    """Deformable self-attention + GELU FFN, post-norm. Eval runs the tail
    through the fused kernel; training runs it op by op with dropout."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, dim_feedforward: int = 1024,
                 ln_eps: float = 1e-6, dropout: float = 0.1):
        super().__init__()
        self.self_attn = DeformableAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=ln_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=ln_eps)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def forward(self, src, pos, reference_points):
        u = src + self.dropout1(self.self_attn(src + pos, src, reference_points))
        if self.training:
            s = layer_norm(u, self.norm1)
            y = self.dropout(F.gelu(linear(s, self.linear1)))  # exact erf
            return layer_norm(s + self.dropout2(linear(y, self.linear2)), self.norm2)
        return fused_ffn_ln(
            u,
            self.linear1.weight.t(), self.linear1.bias,
            self.linear2.weight.t(), self.linear2.bias,
            self.norm1.weight, self.norm1.bias,
            self.norm2.weight, self.norm2.bias,
            eps=self.norm1.eps, compute_dtype=u.dtype,
        )


class LightweightBEVTransformer(nn.Module):
    """One encoder layer over the BEV grid: (B, C, H, W) -> tokens (B, H*W, C)."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, dim_feedforward: int = 1024,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.d_model = d_model
        self.encoder = TransformerEncoderLayer(d_model, n_heads, dim_feedforward, ln_eps)
        # (h, w, device, dtype) -> (position embedding, reference points);
        # built once per grid, as the JAX package bakes them in as constants
        self._grid_consts = {}

    def _consts(self, h, w, device, dtype):
        key = (h, w, device, dtype)
        if key not in self._grid_consts:
            pos = torch.as_tensor(sine_position_embedding(h, w, self.d_model // 2), device=device)
            ys = np.linspace(0, 1, h, dtype=np.float32)
            xs = np.linspace(0, 1, w, dtype=np.float32)
            gy, gx = np.meshgrid(ys, xs, indexing="ij")
            ref = torch.as_tensor(np.stack([gx, gy], axis=-1).reshape(h * w, 2), device=device)
            self._grid_consts[key] = (pos.to(dtype).reshape(1, h * w, -1), ref)
        return self._grid_consts[key]

    def forward(self, x):
        b, c, h, w = x.shape
        pos, ref = self._consts(h, w, x.device, x.dtype)
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        return self.encoder(tokens, pos, ref)
