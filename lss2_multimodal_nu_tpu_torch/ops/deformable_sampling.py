"""Deformable-attention sampling (folded output), its CUDA kernels and its
gradient.

Counterpart of `deformable_sample_combine_xy` in the JAX package's
`ops/deformable_sampling.py`, with one layout change: the value maps are
channel-last, (BH, H*W, dh), which is how `value_proj` produces them. The
forward kernel (`csrc/deformable_sample.cu`) replaces the TPU kernel
`_kernel` of `ops/deformable_pallas.py`, the backward kernels
(`csrc/deformable_sample_backward.cu`) its `_bwd_kernel` with the dense math
of `_bwd_pallas`; each source says what bounds it on the H100. The autograd
Function saves v, lx, ly and attn and recomputes the geometry in the
backward, as the JAX `custom_vjp` does. The backward sums dv in one fixed
order (its points sorted by cell), so on the card it repeats bit for bit, as
the TPU kernel does; `deformable_dv_ordered_plain` is that algorithm in
PyTorch calls.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ..utils import profiling
from .lift_splat import sort_points_plain

# Points of one cell that a lane group of the dv pass sums itself; the
# points of a cell with more are summed in pieces of at most this many
# sorted positions first (`csrc/deformable_sample_backward.cu`).
DV_CHUNK = 128


def _geometry(lx: torch.Tensor, ly: torch.Tensor, h: int, w: int):
    """(x0, y0, wx, wy) in float32 of samples at lx, ly (align_corners=False):
    fx = lx*w - 0.5, x0 = floor(fx), wx = fx - x0, the same for y. The plain
    versions' one geometry, as `csrc/deformable.cuh::sample` is the
    kernels'."""
    fx = lx.float() * w - 0.5
    fy = ly.float() * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    return x0, y0, fx - x0, fy - y0


def _corners(lx: torch.Tensor, ly: torch.Tensor, h: int, w: int):
    """Bilinear geometry of one point's samples (zero padding): (wx, wy,
    [(row index into H*W, weight, inside the map) for the corners 00, 01,
    10, 11]), in float32."""
    x0, y0, wx, wy = _geometry(lx, ly, h, w)
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


def dv_csr_plain(lx: torch.Tensor, ly: torch.Tensor, h: int, w: int):
    """The points sorted by cell, as the backward kernel's keys and sort
    build them: point i = (bh * npts + p) * N + q gets the key bh * cells +
    (y0 + 1) * (w + 1) + x0 + 1, cells = (h + 1) * (w + 1) (a grid of the
    corner-00 cells with a border of one at the top and the left, where x0
    or y0 is -1 and other corners are inside), or BH * cells when none of
    its corners is inside. Returns (order (BH*npts*N,) int64, rowptr (BH *
    cells + 1,) int32), `sort_points_plain`'s CSR: the points of key k are
    order[rowptr[k]:rowptr[k + 1]], in point order."""
    bh = lx.shape[0]
    cells = (h + 1) * (w + 1)
    x0, y0, _, _ = _geometry(lx, ly, h, w)
    live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    cell = torch.where(live, (y0 + 1) * (w + 1) + x0 + 1, 0).to(torch.int32)
    key = torch.arange(bh, dtype=torch.int32, device=lx.device).view(-1, 1, 1) * cells + cell
    return sort_points_plain(key.view(1, -1), live.view(1, -1).float(), bh * cells)


def deformable_dv_ordered_plain(lx, ly, attn, g, h: int, w: int, chunk: int = DV_CHUNK):
    """Plain version of the backward kernel's dv: (BH, H*W, dh) float32, the
    same function as the dv of `deformable_sample_combine_xy_backward_plain`
    summed in the kernel's order, for checking its index arithmetic. With
    the points sorted by cell (`dv_csr_plain`), dv row (bh, y, x) sums the
    points of cells (y-1, x-1), (y-1, x), (y, x-1), (y, x) with their
    corners 11, 10, 01, 00, in that order, each cell in sorted order,
    attn * wt * g[q] one point after another. A cell of more than `chunk`
    points is summed ahead in pieces cut at every multiple of `chunk` in the
    sorted list (slot 2 t of block t's first position, slot 2 t + 1 of a
    cell that starts inside block t), and the row adds its pieces in
    order."""
    bh, npts, n = lx.shape
    dh = g.shape[-1]
    cells, dead = (h + 1) * (w + 1), bh * (h + 1) * (w + 1)
    order, rowptr = dv_csr_plain(lx, ly, h, w)
    rowptr = rowptr.long()
    total = order.numel()
    _, _, wx, wy = _geometry(lx.reshape(-1), ly.reshape(-1), h, w)
    wts = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], 1)
    # per sorted position: attn * the corner weights, and its row of g
    aw = (wts * attn.reshape(-1, 1).float())[order]
    g_rows = g.float().reshape(bh * n, dh)[order // (npts * n) * n + order % n]
    # the cell key of each sorted position (the kernel reads CUB's sorted keys)
    key = torch.bucketize(torch.arange(total, device=lx.device), rowptr, right=True) - 1

    def add(acc, pos, corner, m):
        """acc + attn * wt * g at sorted positions pos where m."""
        pos = pos.clamp(0, total - 1)
        return acc + torch.where(m[..., None], aw[pos, corner][..., None] * g_rows[pos], 0.0)

    # the long cells' pieces, block t's two slots
    blocks = -(-total // chunk)
    pos0 = torch.arange(blocks, device=lx.device) * chunk
    end = (pos0 + chunk).clamp(max=total)
    slots = torch.zeros(blocks, 2, 4, dh, dtype=torch.float32, device=lx.device)
    first = key[pos0]
    for piece, k_p in ((0, first), (1, key[end - 1])):
        live = (k_p < dead) if piece == 0 else (k_p < dead) & (k_p != first)
        k_c = k_p.clamp(max=dead - 1)
        b0, b1 = rowptr[k_c], rowptr[k_c + 1]
        long = live & (b1 - b0 > chunk)
        k = pos0 if piece == 0 else b0
        k1 = torch.minimum(b1, end)
        acc = torch.zeros(blocks, 4, dh, dtype=torch.float32, device=lx.device)
        for j in range(int((k1 - k)[long].max()) if bool(long.any()) else 0):
            for corner in range(4):
                acc[:, corner] = add(acc[:, corner], k + j, corner, long & (k + j < k1))
        slots[:, piece] = acc
    slots = slots.reshape(2 * blocks, 4, dh)

    # the rows: four cells each, short ones point by point, long ones by slots
    y, x = torch.meshgrid(torch.arange(h, device=lx.device), torch.arange(w, device=lx.device),
                          indexing="ij")
    row_cell = (y * (w + 1) + x).reshape(1, -1)
    maps = torch.arange(bh, device=lx.device).view(-1, 1) * cells
    dv = torch.zeros(bh, h * w, dh, dtype=torch.float32, device=lx.device)
    for b in range(4):
        corner = 3 - b
        k_b = maps + row_cell + (b >> 1) * (w + 1) + (b & 1)
        lo, hi = rowptr[k_b], rowptr[k_b + 1]
        short = hi - lo <= chunk
        for j in range(int((hi - lo)[short].max()) if bool(short.any()) else 0):
            dv = add(dv, lo + j, corner, short & (lo + j < hi))
        t0, t1 = lo // chunk, -(-hi // chunk)
        for j in range(int((t1 - t0)[~short].max()) if bool((~short).any()) else 0):
            slot = 2 * (t0 + j) + ((lo % chunk != 0) & (j == 0)).long()
            m = ~short & (t0 + j < t1)
            dv = dv + torch.where(m[..., None], slots[slot.clamp(max=2 * blocks - 1), corner], 0.0)
    return dv


_SYMBOL = {torch.float32: "deform_sample_f32", torch.bfloat16: "deform_sample_bf16"}
_DV_SYMBOL = {torch.float32: "deform_sample_bwd_dv_f32",
              torch.bfloat16: "deform_sample_bwd_dv_bf16"}
_QUERY_SYMBOL = {torch.float32: "deform_sample_bwd_query_f32",
                 torch.bfloat16: "deform_sample_bwd_query_bf16"}


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


@profiling.op("op.deformable_sample")
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


_P, _I, _LL = _build.P, _build.I, ctypes.c_longlong
_BWD_ARGTYPES = {
    "deform_sample_bwd_sort": [_P] * 4 + [_LL] + [_I] * 7 + [_P],
    **{sym: [_P, _P, _LL, _P] + [_I] * 7 + [_P] for sym in _DV_SYMBOL.values()},
    **{sym: [_P] * 8 + [_I] * 6 + [_P] for sym in _QUERY_SYMBOL.values()},
}


@lru_cache(maxsize=None)
def _bwd_fn(symbol: str):
    """The backward's C entry point `symbol`, bound once."""
    return _build.bind("deformable_sample_backward", symbol, _BWD_ARGTYPES[symbol])


@lru_cache(maxsize=16)
def _scratch_bytes(bh, npts, n, h, w, dh) -> int:
    """Bytes of the backward's scratch (`deform_sample_bwd_scratch`)."""
    fn = _build.library("deformable_sample_backward").deform_sample_bwd_scratch
    fn.argtypes, fn.restype = [_I] * 7, _LL
    return int(fn(bh, npts, n, h, w, dh, DV_CHUNK))


def _backward_steps(v, lx, ly, attn, g, h: int, w: int):
    """The backward on the card as its three steps, each a call into
    `csrc/deformable_sample_backward.cu` on the current stream: ({"keys and
    sort", "dv", "query": a function launching it}, in launch order, and
    the (dv float32, dlx, dly, dattn) they write). The scratch (the sort's,
    the CSR, the long cells' slots) comes from PyTorch's caching allocator;
    nothing syncs the host."""
    lx32, ly32, a32 = _check_args(v, lx, ly, attn, h, w, _DV_SYMBOL, "backward")
    bh, hw, dh = v.shape
    npts, n = lx.shape[1], lx.shape[2]
    if g.shape != (bh, n, dh) or g.dtype != v.dtype:
        raise ValueError(f"cotangent {g.dtype}{tuple(g.shape)}, expected {v.dtype}{(bh, n, dh)}")
    if bh * npts * n + DV_CHUNK >= 2 ** 31 or bh * (h + 1) * (w + 1) >= 2 ** 31:
        raise ValueError("the deformable-sampling backward indexes points and cells with 31-bit "
                         "integers")
    _build.same_device(v, g)
    v, g = _aligned(v), _aligned(g)
    nbytes = _scratch_bytes(bh, npts, n, h, w, dh)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=v.device)
    dv = torch.empty(bh, hw, dh, dtype=torch.float32, device=v.device)
    dlx, dly, dattn = (torch.empty(bh, npts, n, dtype=torch.float32, device=v.device)
                       for _ in range(3))
    dims = (bh, npts, n, h, w, dh)

    def launch(symbol, *args):
        code = _bwd_fn(symbol)(*args, _build.stream(v.device))
        _build.check("deformable_sample_backward", code)

    def sort():
        launch("deform_sample_bwd_sort", *map(_build.ptr, (lx32, ly32, a32, scratch)), nbytes,
               *dims, DV_CHUNK)

    def dv_pass():
        launch(_DV_SYMBOL[v.dtype], *map(_build.ptr, (g, scratch)), nbytes, _build.ptr(dv),
               *dims, DV_CHUNK)

    def query():
        launch(_QUERY_SYMBOL[v.dtype], *map(_build.ptr, (v, lx32, ly32, a32, g, dlx, dly, dattn)),
               *dims)

    return {"keys and sort": sort, "dv": dv_pass, "query": query}, (dv, dlx, dly, dattn)


@profiling.op("op.deformable_sample_backward")
def deformable_sample_combine_xy_backward(v, lx, ly, attn, g, h: int, w: int):
    """(dv, dlx, dly, dattn) in the dtypes of (v, lx, ly, attn) for the
    cotangent g (BH, N, dh) of the output.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernels
    (v and g float32 or bfloat16 of one dtype; dv is summed in float32, in
    one fixed order, and cast once), and the result repeats bit for bit."""
    if v.device.type == "cpu":
        return deformable_sample_combine_xy_backward_plain(v, lx, ly, attn, g, h, w)
    steps, (dv, dlx, dly, dattn) = _backward_steps(v, lx, ly, attn, g, h, w)
    with torch.cuda.device(v.device):
        for step in steps.values():
            step()
    deformable_sample_combine_xy_backward.launches += 1
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
