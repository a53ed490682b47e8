"""Fused lift + splat (voxel pooling), its CUDA kernels and its gradient.

Counterpart of `ops/lift_splat.py::lift_splat` (fused path) and
`ops/lift_splat_pallas.py::fused_lift_splat` of the JAX package. The forward
kernel (`csrc/lift_splat.cu`) replaces the TPU kernel `_kernel` of
`lift_splat_pallas.py`; the backward kernel (`csrc/lift_splat_backward.cu`)
computes the math of the JAX package's `_fused_bwd`, which is XLA there. Both
reduce over the points of one output row in a fixed order, through a CSR
that `sort_points` builds on the device (a stable sort of the points by
row), so on the card both repeat bit for bit from run to run. Each source
says what bounds it on the H100.
"""
from __future__ import annotations

import contextlib
import ctypes
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


def fused_lift_splat_backward_plain(feat, depth, seg, fidx, g):
    """Plain version of the backward, and its composite yardstick on the card
    (no single PyTorch call computes it): (dfeat, ddepth) for the cotangent g
    (B, n_voxels, C) of the output, in the dtypes of (feat, depth): g_rows =
    g[b, seg[p]]; ddepth[p] = <g_rows[p], feat[b, fidx[p]]>; dfeat[b, fidx[p]]
    += depth[p] * g_rows[p], summed in float32. seg and fidx get no
    gradient."""
    b, r, c = feat.shape
    g_rows = torch.gather(g.float(), 1, seg.long()[..., None].expand(-1, -1, c))
    feat_rows = torch.gather(feat.float(), 1, fidx.long()[..., None].expand(-1, -1, c))
    ddepth = (g_rows * feat_rows).sum(-1).to(depth.dtype)
    offs = (torch.arange(b, device=feat.device) * r)[:, None]
    dfeat = torch.zeros(b * r, c, dtype=torch.float32, device=feat.device)
    dfeat.index_add_(0, (fidx.long() + offs).reshape(-1),
                     (depth.float()[..., None] * g_rows).reshape(-1, c))
    return dfeat.view(b, r, c).to(feat.dtype), ddepth


P, I, LL = _build.P, _build.I, ctypes.c_longlong
_ARGTYPES = {
    "lift_splat_sort": [P, P, P, LL, P, P, I, I, I, P],
    "lift_splat_f32": [P] * 5 + [LL, P] + [I] * 5 + [P],
    "lift_splat_bf16": [P] * 5 + [LL, P] + [I] * 5 + [P],
    "lift_splat_backward_f32": [P] * 8 + [I] * 4 + [P],
    "lift_splat_backward_bf16": [P] * 8 + [I] * 4 + [P],
}


@lru_cache(maxsize=None)
def _fn(symbol: str):
    """The C entry point `symbol`, bound once: its library is
    `lift_splat_backward` for the backward's, else `lift_splat`."""
    lib = "lift_splat_backward" if "backward" in symbol else "lift_splat"
    return _build.bind(lib, symbol, _ARGTYPES[symbol])


@lru_cache(maxsize=16)
def _scratch_bytes(b: int, p: int, n_rows: int, forward: bool) -> int:
    """Bytes of device scratch for `sort_points` or, with `forward`, for the
    forward kernel (`csrc/lift_splat.cu::lift_splat_scratch`)."""
    fn = _build.library("lift_splat").lift_splat_scratch
    fn.argtypes, fn.restype = [I, I, I, I], LL
    return int(fn(b, p, n_rows, int(forward)))


def _on(device):
    """`torch.cuda.device(device)` unless it is the current one already
    (entering it costs the host a few microseconds a call)."""
    same = device.index is None or device.index == torch.cuda.current_device()
    return contextlib.nullcontext() if same else torch.cuda.device(device)


def _key_bits(b: int, p: int, n_rows: int) -> int:
    """bbits, the bits of the batch index in a CSR key (r << bbits) | b;
    ValueError where the B*P points or the keys would not fit in 31 bits
    (the kernels index them with int)."""
    bbits = (b - 1).bit_length()
    if b * p >= 2 ** 31 or (n_rows << bbits) >= 2 ** 31:
        raise ValueError("lift-splat indexes points and rows with 31-bit integers")
    return bbits


def sort_points_plain(row, weight, n_rows: int):
    """Plain version of `sort_points`, in PyTorch calls on row's device: the
    same CSR (order as int64) from the keys by PyTorch ops,
    `torch.sort(stable=True)` and `torch.searchsorted`. It checks no row: a
    live point's row out of range gives a wrong CSR, not an error."""
    b, p = row.shape
    bbits = _key_bits(b, p, n_rows)
    live = torch.ones_like(row, dtype=torch.bool) if weight is None else weight != 0
    ids = torch.arange(b, device=row.device, dtype=torch.int32)[:, None]
    key = ((torch.where(live, row.to(torch.int32), n_rows) << bbits) | ids).reshape(-1)
    key, order = torch.sort(key, stable=True)
    keys = torch.arange((n_rows << bbits) + 1, device=row.device, dtype=torch.int32)
    return order, torch.searchsorted(key, keys, out_int32=True)


def sort_points(row, weight, n_rows: int):
    """The index preparation of both kernels: a CSR of the points by row.

    row (B, P) int32, each point's row within its batch element; weight
    (B, P) float32, or None when every point is live. Row r of batch
    element b has the key (r << bbits) | b, bbits = (B - 1).bit_length();
    its live points (weight != 0) are order[rowptr[key]:rowptr[key + 1]],
    in point order, as points b * P + p. Every other point sorts after all
    rows and is never visited. Returns (order (B*P,) int32, rowptr
    ((n_rows << bbits) + 1,) int32).

    On the card it is one call into `csrc/lift_splat.cu::lift_splat_sort`:
    a keys kernel (which traps on a live point's row out of range), CUB's
    stable radix sort over the row bits of the key (the points arrive
    ordered by b, so a stable sort by row orders them by the whole key), and
    a binary search per key; no host sync. On the CPU it is the plain
    version, after a check that raises on a live point's row out of
    range."""
    b, p = row.shape
    n_keys = n_rows << _key_bits(b, p, n_rows)
    if row.device.type != "cuda":
        live = torch.ones_like(row, dtype=torch.bool) if weight is None else weight != 0
        if bool(((row < 0) | (row >= n_rows))[live].any()):
            raise ValueError(f"a live point's row is outside [0, {n_rows})")
        order, rowptr = sort_points_plain(row, weight, n_rows)
        return order.to(torch.int32), rowptr
    row = row.to(torch.int32).contiguous()
    if weight is not None:
        weight = weight.to(torch.float32).contiguous()
        _build.same_device(row, weight)
    nbytes = _scratch_bytes(b, p, n_rows, False)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=row.device)
    order = torch.empty(b * p, dtype=torch.int32, device=row.device)
    rowptr = torch.empty(n_keys + 1, dtype=torch.int32, device=row.device)
    with _on(row.device):
        code = _fn("lift_splat_sort")(
            None if weight is None else _build.ptr(weight), _build.ptr(row), _build.ptr(scratch),
            nbytes, _build.ptr(order), _build.ptr(rowptr), b, p, n_rows,
            _build.stream(row.device))
    _build.check("lift_splat", code)
    return order, rowptr


_SYMBOL = {torch.float32: "lift_splat_f32", torch.bfloat16: "lift_splat_bf16"}
_BWD_SYMBOL = {torch.float32: "lift_splat_backward_f32",
               torch.bfloat16: "lift_splat_backward_bf16"}


def _rows_for_kernel(t, c):
    """t contiguous and 16-byte aligned, its rows of c values a whole number
    of 16-byte slices, at most 128 of them (the kernels' lanes own 16-byte
    slices): else ValueError."""
    row_bytes = c * t.element_size()
    if row_bytes == 0 or row_bytes % 16 or row_bytes > 128 * 16:
        raise ValueError(f"the lift-splat kernels take rows of 16 to 2048 bytes in whole 16-byte "
                         f"slices; C={c} in {t.dtype} is {row_bytes} bytes")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(feat, depth, seg, fidx, n_voxels: int) -> torch.Tensor:
    """The forward on feat's device: the plain version on the CPU, else one
    call into `csrc/lift_splat.cu`: the CSR of the points by voxel (as
    `sort_points` builds it), then the kernel."""
    if feat.device.type == "cpu":
        return fused_lift_splat_plain(feat, depth, seg, fidx, n_voxels)
    if feat.device.type != "cuda" or feat.dtype not in _SYMBOL:
        raise ValueError(f"no lift-splat kernel for {feat.dtype} on {feat.device}")
    b, r, c = feat.shape
    p = depth.shape[1]
    if depth.shape != (b, p) or seg.shape != (b, p) or fidx.shape != (b, p):
        raise ValueError("depth, seg and fidx must all be (B, P)")
    _build.same_device(feat, depth, seg, fidx)
    _key_bits(b, p, n_voxels)
    if b * n_voxels * c * feat.element_size() // 16 >= 2 ** 30:  # the output's 16-byte slices
        raise ValueError("lift-splat indexes points and rows with 31-bit integers")
    feat = _rows_for_kernel(feat, c)
    depth = depth.to(torch.float32).contiguous()
    seg = seg.to(torch.int32).contiguous()
    fidx = fidx.to(torch.int32).contiguous()
    nbytes = _scratch_bytes(b, p, n_voxels, True)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=feat.device)
    out = torch.empty(b, n_voxels, c, dtype=feat.dtype, device=feat.device)
    with _on(feat.device):
        code = _fn(_SYMBOL[feat.dtype])(
            *map(_build.ptr, (feat, depth, seg, fidx, scratch)), nbytes, _build.ptr(out),
            b, p, r, c, n_voxels, _build.stream(feat.device))
    fused_lift_splat.launches += 1
    _build.check("lift_splat", code)
    return out


def fused_lift_splat_backward(feat, depth, seg, fidx, g, *, _fidx_csr=None):
    """(dfeat, ddepth) of `fused_lift_splat` for the cotangent g (B,
    n_voxels, C), in the dtypes of (feat, depth); ddepth covers every point,
    depth 0 or not. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (feat and g float32 or bfloat16, the same dtype),
    which walks each feature row's points through a CSR over fidx:
    `_fidx_csr`, the cached CSR of the frustum's constant map, or one built
    here by `sort_points`."""
    if feat.device.type == "cpu":
        return fused_lift_splat_backward_plain(feat, depth, seg, fidx, g)
    if feat.device.type != "cuda" or feat.dtype not in _BWD_SYMBOL or g.dtype != feat.dtype:
        raise ValueError(f"no lift-splat backward kernel for feat {feat.dtype} and g {g.dtype} "
                         f"on {feat.device}")
    b, r, c = feat.shape
    p = depth.shape[1]
    n_voxels = g.shape[1]
    if depth.shape != (b, p) or seg.shape != (b, p) or fidx.shape != (b, p) or g.shape != (b, n_voxels, c):
        raise ValueError("depth, seg and fidx must all be (B, P) and g (B, n_voxels, C)")
    _build.same_device(feat, depth, seg, fidx, g)
    _key_bits(b, p, r)
    feat, g = _rows_for_kernel(feat, c), _rows_for_kernel(g, c)
    depth32 = depth.to(torch.float32).contiguous()
    seg = seg.to(torch.int32).contiguous()
    order, ptr = _fidx_csr if _fidx_csr is not None else sort_points(fidx, None, r)
    dfeat = torch.empty_like(feat)
    ddepth = torch.empty(b, p, dtype=torch.float32, device=feat.device)
    with _on(feat.device):
        code = _fn(_BWD_SYMBOL[feat.dtype])(
            *map(_build.ptr, (feat, depth32, seg, g, order, ptr, dfeat, ddepth)),
            b, r, c, n_voxels, _build.stream(feat.device))
    fused_lift_splat_backward.launches += 1
    _build.check("lift_splat_backward", code)
    return dfeat, ddepth.to(depth.dtype)


fused_lift_splat_backward.launches = 0


class _FusedLiftSplat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, depth, seg, fidx, n_voxels, fidx_csr):
        ctx.save_for_backward(feat, depth, seg, fidx)
        ctx.fidx_csr = fidx_csr
        return _forward(feat, depth, seg, fidx, n_voxels)

    @staticmethod
    def backward(ctx, g):
        dfeat, ddepth = fused_lift_splat_backward(*ctx.saved_tensors, g, _fidx_csr=ctx.fidx_csr)
        return dfeat, ddepth, None, None, None, None


def fused_lift_splat(feat, depth, seg, fidx, n_voxels: int, *, _fidx_csr=None) -> torch.Tensor:
    """(B, n_voxels, C): bev[b, seg[p]] += depth[p] * feat[b, fidx[p]],
    differentiable in feat and depth.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which sums each output row's points in float32 in a fixed order and
    writes the row once in feat's dtype (C a whole number of 16-byte slices:
    else ValueError). The backward is `fused_lift_splat_backward` on either
    device; `_fidx_csr`, internal, passes it the cached CSR of a constant
    fidx. Where autograd records nothing (no grad mode, or neither feat nor
    depth needs a gradient) the forward is called directly: the autograd
    Function would add 7-29 us of host time to a call that the host
    bounds (`scripts/port_lift_splat.py`)."""
    if torch.is_grad_enabled() and (feat.requires_grad or depth.requires_grad):
        return _FusedLiftSplat.apply(feat, depth, seg, fidx, n_voxels, _fidx_csr)
    return _forward(feat, depth, seg, fidx, n_voxels)


fused_lift_splat.launches = 0


@lru_cache(maxsize=8)
def _feature_rows(n: int, d: int, fh: int, fw: int) -> np.ndarray:
    """Point p = (n, d, fh, fw), row-major, reads feature row (n, fh, fw)."""
    nn_, _, hh, ww = np.meshgrid(
        np.arange(n), np.arange(d), np.arange(fh), np.arange(fw), indexing="ij"
    )
    return ((nn_ * fh + hh) * fw + ww).reshape(-1).astype(np.int32)


@lru_cache(maxsize=8)
def _feature_rows_on(n: int, d: int, fh: int, fw: int, b: int, device):
    """(fidx (B, P) int32 on `device`, and on a card its CSR from
    `sort_points`, else None): constants of the frustum's shape, made once
    per shape and device, so that a forward copies nothing from the host and
    sorts nothing for the backward. They are made outside inference mode,
    whatever the first caller's mode: a later training step saves fidx for
    its backward."""
    with torch.inference_mode(False):
        fidx = torch.as_tensor(_feature_rows(n, d, fh, fw), device=device)[None].repeat(b, 1)
        return fidx, sort_points(fidx, None, n * fh * fw) if device.type == "cuda" else None


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
    fidx, csr = _feature_rows_on(n, d, fh, fw, b, feat.device)
    rows = feat.permute(0, 1, 3, 4, 2).reshape(b, n * fh * fw, c)
    bev = fused_lift_splat(rows, depth_w, seg, fidx, z * x * y, _fidx_csr=csr)  # (B, Z*X*Y, C)
    return bev.view(b, z, x, y, c).permute(0, 1, 4, 2, 3).reshape(b, z * c, x, y)
