"""Kernel 8: the VoVNet trunk's float32 convolutions on the tensor cores.

Every `ConvBnAct` of `nn/vovnet.py::VoVNetV2` whose input is a float32 CUDA
tensor, where no gradient flows through it (eval, and training's stage 4,
which runs for its batch-norm statistics alone), runs its conv through
`conv2d_tf32x3`: an implicit GEMM
(`csrc/conv_tf32x3.cu`) in three TF32 passes, a_hi b_hi + a_lo b_hi +
a_hi b_lo (`ops/_tf32.py::split_tf32_rn`: lo rounded to TF32 too), each
item's partial sum added to a float32 accumulator on the CUDA cores, as
close to float64 as cuDNN's float32 conv. It replaces no
TPU kernel (the JAX package leaves its convs to XLA): under the port's
float32 pin cuDNN took FFT tiling for the trunk and ran it at about 2% of
the tensor cores (PERF.md).

The kernel takes groups 1, dilation 1, a square kernel of 1 (padding 0,
stride 1) or 3 (padding 1, stride 1 or 2) and K = Cin k^2 a multiple of 8
(`takes`); the trunk's one conv outside that, the stem's first (Cin = 3,
K = 27), stays on `F.conv2d` by that shape rule. Input and output are
NCHW, so every tensor autograd and cuDNN's backward see keeps its layout.
The weights are split into TF32 hi and lo once per call, (2, taps, Cout,
Cin), K-major, into scratch that the wrapper allocates; activations are
split in registers. With `bias` and `relu` (eval: batch norm folded) the
epilogue adds the bias and applies the ReLU; training's stage 4 passes
neither and batch norm follows. Sums run in one fixed order, so a call
repeats bit for bit.

Convs that a gradient flows through stay on cuDNN. The train step's
gradients are the checked output of training, and those of the trunk's
batch-norm parameters (sums over the batch that nearly cancel) move by
about 3e-3 of their norm for any change of the trunk's forward beyond
cuDNN's own rounding: cuDNN's output with noise of 5e-8 of its largest
value added moves them as far as this kernel does (PERF.md, kernel 8).

A CPU tensor takes the plain version, `F.conv2d` in full float32. The tile
plan (`plan`) is plain Python: the CPU tests replay the kernel's index
arithmetic from it (`tests/test_torch_conv.py`).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from ..utils import profiling
from ._precision import full_float32
from ._tf32 import split_tf32_rn

# (kernel size, stride) -> the (m64 tiles a consumer warpgroup, N) pairs
# instantiated in csrc/conv_tf32x3.cu, those `plan` picks for the
# VoVNet-39 trunk at 48 images of 128 x 352; a block computes 128 * mt
# output pixels by n output channels.
KERNELS = {
    (3, 1): ((2, 64), (2, 128), (1, 32)),
    (3, 2): ((1, 128),),
    (1, 1): ((2, 128), (1, 160), (1, 192)),
}
SMEM = 232448  # bytes of shared memory a block may use on the H100
A_STAGES = {3: 2, 1: 4}  # input tiles in flight: a halo is read by 9 taps, a 1x1 tile by one
MAX_B_STAGES = 8
SMS = 132  # the H100's streaming multiprocessors (the plan's cost model)


class Plan(NamedTuple):
    """How the kernel tiles one conv. A block computes 128 * mt output
    pixels by n output channels. 3x3: a tile is th rows by tw columns of the
    output with the images stacked row after row; its input, rows padded by
    one zero row above and below each image, is the halo of hrows by hcols
    pixels, starting at padded row (r0 // oh) * hp + stride * (r0 % oh).
    1x1: a tile is 128 * mt consecutive pixels of the flattened (b, y, x),
    hrows of them, hcols 1, held as 32 channel rows."""
    ks: int
    stride: int
    mt: int
    n: int
    th: int
    tw: int
    hrows: int
    hcols: int
    hp: int
    m_tiles: int
    col_tiles: int
    n_tiles: int
    abytes: int
    b_stages: int
    smem: int


def out_size(size: int, ks: int, stride: int) -> int:
    return (size + 2 * (ks // 2) - ks) // stride + 1


def takes(cin: int, cout: int, ks, stride, padding, hw: int, dilation=1,
          groups: int = 1) -> bool:
    """Whether kernel 8 runs this conv of an input of hw pixels an image:
    groups 1, dilation 1, a 1x1 (padding 0, stride 1, hw a multiple of 4,
    copied 16 bytes at a time) or 3x3 (padding 1, stride 1 or 2) kernel, and
    K = cin k^2 a multiple of 8. Everything else, such as the stem's first
    conv (cin 3, K 27), stays on `F.conv2d`."""
    pair = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v, v)
    ks, stride, padding, dilation = map(pair, (ks, stride, padding, dilation))
    if groups != 1 or dilation != (1, 1) or ks[0] != ks[1] or stride[0] != stride[1]:
        return False
    k, s = ks[0], stride[0]
    return ((k, s) in KERNELS and padding == (k // 2, k // 2) and (cin * k * k) % 8 == 0
            and cout > 0 and (k == 3 or hw % 4 == 0))


def _halo_rows(b: int, oh: int, hp: int, th: int, stride: int) -> int:
    """Padded input rows that the tallest 3x3 tile of th stacked output rows
    reads (a tile that crosses into the next image skips its padding)."""
    rows = 0
    # tiles start at every th-th row, so their offsets in an image repeat
    # after lcm(oh, th) rows
    for r0 in range(0, min(b * oh, math.lcm(oh, th)), th):
        r1 = min(r0 + th, b * oh) - 1
        first = (r0 // oh) * hp + stride * (r0 % oh)
        last = (r1 // oh) * hp + stride * (r1 % oh) + 2
        rows = max(rows, last - first + 1)
    return rows


def _cost(ks, mt, n, m_tiles, n_tiles, nitem, abytes, sms):
    """Clocks of the busiest SM by a rough model: each (channel slice, tap)
    item takes the larger of its three TF32 passes (1024 multiply-adds a
    clock an SM) and its operand bytes at 16 bytes a clock, plus a fixed
    cost a block."""
    bm = 128 * mt
    item = max(3 * bm * n * 32 / 1024, (2 * n * 128 + abytes / (ks * ks)) / 16, 128) + 64
    waves = math.ceil(m_tiles * n_tiles / sms)
    return waves * (nitem * item + 2000 + bm * n * 4 / 32)


def tile_plan(b: int, cin: int, h: int, w: int, cout: int, ks: int, stride: int, mt: int,
              n: int, tw: int = 0) -> Optional[Plan]:
    """The plan of instantiation (mt, n) with 3x3 tiles tw columns wide
    (th = 128 mt // tw rows), or None where it does not fit in shared
    memory."""
    oh, ow = out_size(h, ks, stride), out_size(w, ks, stride)
    bm = 128 * mt
    if ks == 1:  # 32 channel rows of bm + 8 pixels
        th, hrows, hcols, hp, rt, ct = 0, bm, 1, 0, math.ceil(b * oh * ow / bm), 1
        tile = 32 * (bm + 8) * 4
    else:  # a 128-byte row of 32 channels a halo pixel
        th, hp = bm // tw, h + 2
        hrows, hcols = _halo_rows(b, oh, hp, th, stride), stride * (tw - 1) + 3
        rt, ct = math.ceil(b * oh / th), math.ceil(ow / tw)
        tile = hrows * hcols * 128
    abytes = -(-tile // 1024) * 1024
    bbytes = 2 * n * 128
    fixed = A_STAGES[ks] * abytes + 1024 + 8 * 2 * (A_STAGES[ks] + MAX_B_STAGES)
    b_stages = min(MAX_B_STAGES, (SMEM - fixed) // bbytes)
    if b_stages < 2:
        return None
    return Plan(ks, stride, mt, n, th, tw, hrows, hcols, hp, rt * ct, ct, math.ceil(cout / n),
                abytes, b_stages, fixed + b_stages * bbytes)


@lru_cache(maxsize=256)
def plan(b: int, cin: int, h: int, w: int, cout: int, ks: int, stride: int,
         sms: int = SMS) -> Plan:
    """The tiling of one conv: the instantiation and tile shape that the
    cost model (`_cost`) finds fastest among those that fit in shared
    memory."""
    if (ks, stride) not in KERNELS:
        raise ValueError(f"no conv kernel for a {ks}x{ks} kernel at stride {stride}")
    ow = out_size(w, ks, stride)
    nitem = math.ceil(cin / 32) * ks * ks
    best = None
    for mt, n in KERNELS[(ks, stride)]:
        tws = [0] if ks == 1 else range(min(8, ow), min(ow, 128 * mt) + 1)
        for tw in tws:
            p = tile_plan(b, cin, h, w, cout, ks, stride, mt, n, tw)
            if p is None:
                continue
            key = (_cost(ks, mt, n, p.m_tiles, p.n_tiles, nitem, p.abytes, sms), p.abytes, -tw)
            if best is None or key < best[0]:
                best = (key, p)
    if best is None:
        raise ValueError("no conv tile fits in shared memory")
    return best[1]


@full_float32()
def conv2d_tf32x3_plain(x, w, bias=None, stride: int = 1, padding: int = 0,
                        relu: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: conv (+ bias) (+ ReLU) in
    full float32, whatever torch's TF32 flags say."""
    y = F.conv2d(x, w, bias, stride, padding)
    return F.relu(y) if relu else y


def tf32_split_weight_plain(w: torch.Tensor) -> torch.Tensor:
    """The kernel's operand from a (Cout, Cin, k, k) weight: hi over lo
    (`split_tf32_rn`), (2, k * k, Cout, Cin), each tap's (Cout, Cin) matrix
    K-major."""
    return torch.stack(split_tf32_rn(w.float().flatten(2).permute(2, 0, 1)))


@lru_cache(maxsize=None)
def _fn(symbol: str, argtypes: tuple):
    """The C entry point `symbol` of csrc/conv_tf32x3.cu, bound once."""
    return _build.bind("conv_tf32x3", symbol, list(argtypes))


def tf32_split_weight(w: torch.Tensor) -> torch.Tensor:
    """`tf32_split_weight_plain` by the kernel that each call runs first
    (a float32 CUDA weight)."""
    if w.device.type == "cpu":
        return tf32_split_weight_plain(w)
    if w.dtype != torch.float32 or w.dim() != 4:
        raise ValueError("the TF32 split takes a float32 (Cout, Cin, k, k) weight")
    w = w.contiguous()
    cout, cin, kh, kw = w.shape
    ws = torch.empty(2, kh * kw, cout, cin, dtype=torch.float32, device=w.device)
    P, I = _build.P, _build.I
    with _build.on(w.device):
        code = _fn("conv_tf32x3_split", (P, P, I, I, I, P))(
            _build.ptr(w), _build.ptr(ws), cout, cin, kh * kw, _build.stream(w.device))
    _build.check("conv_tf32x3", code)
    return ws


_ARGTYPES = (_build.P,) * 4 + (_build.I,) * 22 + (_build.P,)


def _launch(x, w, bias, stride: int, relu: bool) -> torch.Tensor:
    bsz, cin, h, wd = x.shape
    cout, _, ks, _ = w.shape
    p = plan(bsz, cin, h, wd, cout, ks, stride, _build.sm_count(x.device))
    oh, ow = out_size(h, ks, stride), out_size(wd, ks, stride)
    x = _build.aligned(x)  # 1x1: 16-byte copies
    ws = tf32_split_weight(w)
    y = torch.empty(bsz, cout, oh, ow, dtype=torch.float32, device=x.device)
    b = bias.contiguous() if bias is not None else None
    with _build.on(x.device):
        code = _fn("conv_tf32x3_f32", _ARGTYPES)(
            _build.ptr(x), _build.ptr(ws), None if b is None else _build.ptr(b), _build.ptr(y),
            bsz, cin, h, wd, cout, oh, ow, ks, stride, p.mt, p.n, p.th, p.tw, p.hrows,
            p.hcols, p.hp, p.col_tiles, p.m_tiles, p.n_tiles, p.abytes, p.b_stages, int(relu),
            _build.stream(x.device))
    _build.check("conv_tf32x3", code)
    return y


@profiling.op("op.conv_tf32x3")
def conv2d_tf32x3(x, w, bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 0, relu: bool = False) -> torch.Tensor:
    """conv2d(x, w, bias, stride, padding) (+ ReLU), x (B, Cin, H, W) and w
    (Cout, Cin, k, k) float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (the shapes `takes` admits), which has no backward and refuses a
    call that autograd would have to differentiate."""
    if x.device.type == "cpu":
        return conv2d_tf32x3_plain(x, w, bias, stride, padding, relu)
    if x.device.type != "cuda" or x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"no conv kernel for {x.dtype} on {x.device}")
    if bias is not None and bias.dtype != torch.float32:
        raise ValueError("the conv kernel's bias is float32")
    cout, cin, kh, _ = w.shape
    if x.dim() != 4 or x.shape[1] != cin or not takes(
            cin, cout, tuple(w.shape[2:]), stride, padding, x.shape[2] * x.shape[3]):
        raise ValueError(f"conv kernel does not take x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"stride {stride}, padding {padding}")
    _build.refuse_grad("conv_tf32x3", x, w, *([] if bias is None else [bias]))
    _build.same_device(x, w, *([] if bias is None else [bias]))
    y = _launch(x, w, bias, stride, relu)
    conv2d_tf32x3.launches += 1
    return y


conv2d_tf32x3.launches = 0
