"""Deformable-attention sampling (folded output), its CUDA kernels and its
gradient.

Counterpart of `deformable_sample_combine_xy` in the JAX package's
`ops/deformable_sampling.py`, with one layout change: the value maps are
channel-last, (BH, H*W, dh), which is how `value_proj` produces them. The
forward kernel (`csrc/deformable_sample.cu`) replaces the TPU kernel
`_kernel` of `ops/deformable_pallas.py`, the backward kernel
(`csrc/deformable_sample_backward.cu`) its `_bwd_kernel` with the dense math
of `_bwd_pallas`; each source says what bounds it on the H100. The autograd
Function saves v, lx, ly and attn and recomputes the geometry in the
backward, as the JAX `custom_vjp` does.
"""
from __future__ import annotations

import torch

from . import _build


def _corners(lx: torch.Tensor, ly: torch.Tensor, h: int, w: int):
    """Bilinear geometry of one point's samples (align_corners=False, zero
    padding): (wx, wy, [(row index into H*W, weight, inside the map) for the
    corners 00, 01, 10, 11]), in float32."""
    fx = lx.float() * w - 0.5
    fy = ly.float() * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    x0, y0 = x0.long(), y0.long()
    corners = []
    for oy, ox, wt in (
        (0, 0, (1 - wy) * (1 - wx)),
        (0, 1, (1 - wy) * wx),
        (1, 0, wy * (1 - wx)),
        (1, 1, wy * wx),
    ):
        yy, xx = y0 + oy, x0 + ox
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        corners.append((yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1), wt, inside))
    return wx, wy, corners


def deformable_sample_combine_xy_plain(
    v: torch.Tensor, lx: torch.Tensor, ly: torch.Tensor, attn: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """Plain version: explicit four-corner gather in float32.

    v (BH, H*W, dh); lx, ly, attn (BH, npts, N) with locations in [0, 1].
    Returns (BH, N, dh) in v's dtype: for each query, the sum over points of
    attn * bilinear(v, lx, ly) (align_corners=False, zero padding).
    """
    bh, hw, dh = v.shape
    npts, n = lx.shape[1], lx.shape[2]
    vf = v.float()
    out = torch.zeros(bh, n, dh, dtype=torch.float32, device=v.device)
    for p in range(npts):
        a = attn[:, p].float()
        for flat, wt, inside in _corners(lx[:, p], ly[:, p], h, w)[2]:
            rows = torch.gather(vf, 1, flat[..., None].expand(bh, n, dh))
            out += rows * (wt * a * inside)[..., None]
    return out.to(v.dtype)


def deformable_sample_combine_xy_backward_plain(
    v: torch.Tensor, lx: torch.Tensor, ly: torch.Tensor, attn: torch.Tensor, g: torch.Tensor,
    h: int, w: int
):
    """Plain version of the backward: the explicit four-corner gradient in
    float32, for the cotangent g (BH, N, dh) of the forward's output.

    Returns (dv, dlx, dly, dattn) in the dtypes of (v, lx, ly, attn). With
    rc_k = <v[corner k], g[q]> (zero outside the map): dv[corner k] +=
    attn * wt_k * g[q]; dattn = sum_k wt_k rc_k; dlx = w * attn * ((1-wy)
    (rc_01 - rc_00) + wy (rc_11 - rc_10)); dly likewise with x and y swapped.
    """
    bh, hw, dh = v.shape
    npts, n = lx.shape[1], lx.shape[2]
    vf, gf = v.float(), g.float()
    dv = torch.zeros(bh, hw, dh, dtype=torch.float32, device=v.device)
    dlx, dly, dattn = (torch.empty(bh, npts, n, dtype=torch.float32, device=v.device)
                       for _ in range(3))
    for p in range(npts):
        a = attn[:, p].float()
        wx, wy, corners = _corners(lx[:, p], ly[:, p], h, w)
        rc = []
        for flat, wt, inside in corners:
            flat = flat[..., None].expand(bh, n, dh)
            rc.append((torch.gather(vf, 1, flat) * gf).sum(-1) * inside)
            dv.scatter_add_(1, flat, gf * (a * wt * inside)[..., None])
        dattn[:, p] = sum(wt * r for (_, wt, _), r in zip(corners, rc))
        dlx[:, p] = w * a * ((1 - wy) * (rc[1] - rc[0]) + wy * (rc[3] - rc[2]))
        dly[:, p] = h * a * ((1 - wx) * (rc[2] - rc[0]) + wx * (rc[3] - rc[1]))
    return dv.to(v.dtype), dlx.to(lx.dtype), dly.to(ly.dtype), dattn.to(attn.dtype)


_SYMBOL = {torch.float32: "deform_sample_f32", torch.bfloat16: "deform_sample_bf16"}
_BWD_SYMBOL = {torch.float32: "deform_sample_bwd_f32", torch.bfloat16: "deform_sample_bwd_bf16"}


def _check_args(v, lx, ly, attn, h, w, symbols, what):
    if v.device.type != "cuda" or v.dtype not in symbols:
        raise ValueError(f"no deformable-sampling {what} kernel for {v.dtype} on {v.device}")
    bh, hw, _ = v.shape
    npts, n = lx.shape[1], lx.shape[2]
    if hw != h * w or lx.shape != (bh, npts, n) or ly.shape != lx.shape or attn.shape != lx.shape:
        raise ValueError(f"bad shapes v{tuple(v.shape)} lx{tuple(lx.shape)} for {h}x{w}")
    if v.shape[2] % 8:
        raise ValueError(f"the deformable-sampling {what} kernel takes dh a multiple of 8, "
                         f"got {v.shape[2]}")
    _build.same_device(v, lx, ly, attn)
    return (t.to(torch.float32).contiguous() for t in (lx, ly, attn))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte boundary: the kernels move 16-byte slices."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(v, lx, ly, attn, h, w):
    """The forward on v's device: the plain version on the CPU, else the
    kernel (v float32 or bfloat16; lx, ly, attn are cast to float32)."""
    if v.device.type == "cpu":
        return deformable_sample_combine_xy_plain(v, lx, ly, attn, h, w)
    lx, ly, attn = _check_args(v, lx, ly, attn, h, w, _SYMBOL, "forward")
    bh, hw, dh = v.shape
    npts, n = lx.shape[1], lx.shape[2]
    v = _aligned(v)
    out = torch.empty(bh, n, dh, dtype=v.dtype, device=v.device)
    P, I = _build.P, _build.I
    fn = _build.bind("deformable_sample", _SYMBOL[v.dtype], [P] * 5 + [I] * 6 + [P])
    with torch.cuda.device(v.device):
        code = fn(*map(_build.ptr, (v, lx, ly, attn, out)), bh, npts, n, h, w, dh,
                  _build.stream(v.device))
    deformable_sample_combine_xy.launches += 1
    _build.check("deformable_sample", code)
    return out


def deformable_sample_combine_xy_backward(v, lx, ly, attn, g, h: int, w: int):
    """(dv, dlx, dly, dattn) in the dtypes of (v, lx, ly, attn) for the
    cotangent g (BH, N, dh) of the output.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (v and g float32 or bfloat16 of one dtype; dv is summed in float32 and
    cast once)."""
    if v.device.type == "cpu":
        return deformable_sample_combine_xy_backward_plain(v, lx, ly, attn, g, h, w)
    lx32, ly32, a32 = _check_args(v, lx, ly, attn, h, w, _BWD_SYMBOL, "backward")
    bh, hw, dh = v.shape
    npts, n = lx.shape[1], lx.shape[2]
    if g.shape != (bh, n, dh) or g.dtype != v.dtype:
        raise ValueError(f"cotangent {g.dtype}{tuple(g.shape)}, expected {v.dtype}{(bh, n, dh)}")
    _build.same_device(v, g)
    v, g = _aligned(v), _aligned(g)
    dv = torch.zeros(bh, hw, dh, dtype=torch.float32, device=v.device)
    dlx, dly, dattn = (torch.empty(bh, npts, n, dtype=torch.float32, device=v.device)
                       for _ in range(3))
    P, I = _build.P, _build.I
    fn = _build.bind("deformable_sample_backward", _BWD_SYMBOL[v.dtype], [P] * 9 + [I] * 6 + [P])
    with torch.cuda.device(v.device):
        code = fn(*map(_build.ptr, (v, lx32, ly32, a32, g, dv, dlx, dly, dattn)),
                  bh, npts, n, h, w, dh, _build.stream(v.device))
    deformable_sample_combine_xy_backward.launches += 1
    _build.check("deformable_sample_backward", code)
    return dv.to(v.dtype), dlx.to(lx.dtype), dly.to(ly.dtype), dattn.to(attn.dtype)


class _DeformableSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, lx, ly, attn, h, w):
        ctx.save_for_backward(v, lx, ly, attn)
        ctx.hw = (h, w)
        return _forward(v, lx, ly, attn, h, w)

    @staticmethod
    def backward(ctx, g):
        v, lx, ly, attn = ctx.saved_tensors
        grads = deformable_sample_combine_xy_backward(v, lx, ly, attn, g.to(v.dtype), *ctx.hw)
        return (*grads, None, None)


def deformable_sample_combine_xy(
    v: torch.Tensor, lx: torch.Tensor, ly: torch.Tensor, attn: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(BH, N, dh) attention-weighted bilinear samples, differentiable in
    v, lx, ly and attn.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    forward kernel, and the backward kernel when autograd asks for the
    gradient (v float32 or bfloat16; lx, ly, attn are cast to float32)."""
    return _DeformableSample.apply(v, lx, ly, attn, h, w)


deformable_sample_combine_xy.launches = 0
deformable_sample_combine_xy_backward.launches = 0
