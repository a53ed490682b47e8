"""Fused lift + splat (voxel pooling), its CUDA kernel and its gradient.

Counterpart of `ops/lift_splat.py::lift_splat` (fused path) and
`ops/lift_splat_pallas.py::fused_lift_splat` of the JAX package. The kernel
(`csrc/lift_splat.cu`) replaces the TPU kernel `_kernel` of
`lift_splat_pallas.py`; its source says what bounds it on the H100. The
backward is the math of the JAX package's `_fused_bwd`, which is XLA there
and PyTorch here: gather the cotangent rows, a dot with the feature rows
for the depth weights, an `index_add_` in float32 for the features.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build


def fused_lift_splat_plain(feat, depth, seg, fidx, n_voxels: int) -> torch.Tensor:
    """Plain version: gather feature rows, weight them, `index_add_`.

    feat (B, R, C); depth (B, P) float32 lift weights (0 for invalid points);
    seg, fidx (B, P) int32. Returns (B, n_voxels, C) in feat's dtype, summed
    in float32."""
    b, r, c = feat.shape
    rows = torch.gather(feat.float(), 1, fidx.long()[..., None].expand(-1, -1, c))
    vals = rows * depth.float()[..., None]
    out = torch.zeros(b * n_voxels, c, dtype=torch.float32, device=feat.device)
    offs = (torch.arange(b, device=feat.device) * n_voxels)[:, None]
    out.index_add_(0, (seg.long() + offs).reshape(-1), vals.reshape(-1, c))
    return out.view(b, n_voxels, c).to(feat.dtype)


_SYMBOL = {torch.float32: "lift_splat_f32", torch.bfloat16: "lift_splat_bf16"}


def _forward(feat, depth, seg, fidx, n_voxels: int) -> torch.Tensor:
    """The forward on feat's device: the plain version on the CPU, else the
    kernel, which sums in float32 with atomics and casts to feat's dtype."""
    if feat.device.type == "cpu":
        return fused_lift_splat_plain(feat, depth, seg, fidx, n_voxels)
    if feat.device.type != "cuda" or feat.dtype not in _SYMBOL:
        raise ValueError(f"no lift-splat kernel for {feat.dtype} on {feat.device}")
    b, r, c = feat.shape
    p = depth.shape[1]
    if depth.shape != (b, p) or seg.shape != (b, p) or fidx.shape != (b, p):
        raise ValueError("depth, seg and fidx must all be (B, P)")
    _build.same_device(feat, depth, seg, fidx)
    feat = feat.contiguous()
    depth = depth.to(torch.float32).contiguous()
    seg = seg.to(torch.int32).contiguous()
    fidx = fidx.to(torch.int32).contiguous()
    out = torch.zeros(b, n_voxels, c, dtype=torch.float32, device=feat.device)
    P, I = _build.P, _build.I
    fn = _build.bind("lift_splat", _SYMBOL[feat.dtype], [P] * 5 + [I] * 5 + [P])
    with torch.cuda.device(feat.device):
        code = fn(*map(_build.ptr, (feat, depth, seg, fidx, out)), b, p, r, c, n_voxels,
                  _build.stream(feat.device))
    fused_lift_splat.launches += 1
    _build.check("lift_splat", code)
    return out.to(feat.dtype)


def fused_lift_splat_backward(feat, depth, seg, fidx, g):
    """(dfeat, ddepth) for the cotangent g (B, n_voxels, C) of the output, in
    the dtypes of (feat, depth): g_rows = g[b, seg[p]]; ddepth[p] =
    <g_rows[p], feat[b, fidx[p]]>; dfeat[b, fidx[p]] += depth[p] * g_rows[p],
    summed in float32. seg and fidx get no gradient."""
    b, r, c = feat.shape
    g_rows = torch.gather(g.float(), 1, seg.long()[..., None].expand(-1, -1, c))
    feat_rows = torch.gather(feat.float(), 1, fidx.long()[..., None].expand(-1, -1, c))
    ddepth = (g_rows * feat_rows).sum(-1).to(depth.dtype)
    offs = (torch.arange(b, device=feat.device) * r)[:, None]
    dfeat = torch.zeros(b * r, c, dtype=torch.float32, device=feat.device)
    dfeat.index_add_(0, (fidx.long() + offs).reshape(-1),
                     (depth.float()[..., None] * g_rows).reshape(-1, c))
    return dfeat.view(b, r, c).to(feat.dtype), ddepth


class _FusedLiftSplat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, depth, seg, fidx, n_voxels):
        ctx.save_for_backward(feat, depth, seg, fidx)
        return _forward(feat, depth, seg, fidx, n_voxels)

    @staticmethod
    def backward(ctx, g):
        dfeat, ddepth = fused_lift_splat_backward(*ctx.saved_tensors, g)
        return dfeat, ddepth, None, None, None


def fused_lift_splat(feat, depth, seg, fidx, n_voxels: int) -> torch.Tensor:
    """(B, n_voxels, C): bev[b, seg[p]] += depth[p] * feat[b, fidx[p]],
    differentiable in feat and depth.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which sums in float32 with atomics and casts to feat's dtype. The
    backward is `fused_lift_splat_backward` on either device."""
    return _FusedLiftSplat.apply(feat, depth, seg, fidx, n_voxels)


fused_lift_splat.launches = 0


@lru_cache(maxsize=8)
def _feature_rows(n: int, d: int, fh: int, fw: int) -> np.ndarray:
    """Point p = (n, d, fh, fw), row-major, reads feature row (n, fh, fw)."""
    nn_, _, hh, ww = np.meshgrid(
        np.arange(n), np.arange(d), np.arange(fh), np.arange(fw), indexing="ij"
    )
    return ((nn_ * fh + hh) * fw + ww).reshape(-1).astype(np.int32)


def lift_splat(feat, depth, idx, valid, nx) -> torch.Tensor:
    """Lift + splat over all cameras.

    feat (B, N, C, fH, fW); depth (B, N, D, fH, fW); idx (B, N, D, fH, fW, 3)
    int32 voxel coordinates; valid (B, N, D, fH, fW) bool; nx the grid size
    (X, Y, Z). Returns (B, Z*C, X, Y), channel z*C + c (z-major collapse).
    """
    b, n, d, fh, fw = depth.shape
    c = feat.shape[2]
    x, y, z = int(nx[0]), int(nx[1]), int(nx[2])
    p = n * d * fh * fw
    idx_f = idx.reshape(b, p, 3)
    valid_f = valid.reshape(b, p)
    seg = (idx_f[..., 2] * x + idx_f[..., 0]) * y + idx_f[..., 1]
    seg = torch.where(valid_f, seg, torch.zeros_like(seg)).to(torch.int32)
    depth_w = torch.where(valid_f, depth.reshape(b, p).float(), torch.zeros((), device=depth.device))
    fidx = torch.as_tensor(_feature_rows(n, d, fh, fw), device=feat.device)
    fidx = fidx[None].expand(b, p)
    rows = feat.permute(0, 1, 3, 4, 2).reshape(b, n * fh * fw, c)
    bev = fused_lift_splat(rows, depth_w, seg, fidx, z * x * y)  # (B, Z*X*Y, C)
    return bev.view(b, z, x, y, c).permute(0, 1, 4, 2, 3).reshape(b, z * c, x, y)
