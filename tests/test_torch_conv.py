"""Kernel 8 (`ops/conv.py`, `csrc/conv_tf32x3.cu`) on the CPU, no JAX.

The CUDA kernel runs only on the card (`tests/test_torch_kernels_cuda.py`).
Here: its plain version against float64 `F.conv2d` at every shape class of
the VoVNet trunk; the kernel's index arithmetic, replayed in float64 from
the tile plan exactly as the source computes it (the input tile's copy,
each lane's ldmatrix rows and tap offsets, the epilogue's stores), against
`F.conv2d`, with every output element written once, at ragged shapes and
at tiles that cross from one image into the next; every tile of the
trunk's own plans at B = 48 inside its halo; the plain version's
gradients; the shape rule that keeps the stem's first conv on `F.conv2d`;
and `ConvBnAct`'s routing: float32 convs that no gradient flows through
to the kernel's entry point, 26 convs of a VoVNet-39 eval forward to c3,
12 of a train forward, bfloat16 never.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lss2_multimodal_nu_tpu_torch.nn import layers
from lss2_multimodal_nu_tpu_torch.nn.vovnet import TIMM_CONFIGS, VoVNetV2
from lss2_multimodal_nu_tpu_torch.ops import conv


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


# (B, Cin, H, W, Cout, k, stride): the trunk's classes at small sizes
SHAPES = {
    "3x3_stride1": (2, 64, 16, 44, 64, 3, 1),
    "3x3_stride2": (2, 64, 32, 88, 128, 3, 2),
    "1x1": (2, 768, 8, 22, 256, 1, 1),
    "3x3_ragged": (3, 40, 7, 11, 72, 3, 1),
    "3x3_stride2_ragged": (2, 16, 9, 13, 24, 3, 2),
    "1x1_ragged": (3, 56, 5, 8, 100, 1, 1),
}


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_float64(shape, relu):
    """The plain version (the CPU path) within float32 rounding of float64
    `F.conv2d`: 2e-6 of the largest output."""
    b, cin, h, w, cout, k, s = SHAPES[shape]
    x, wt, bias = _rand(1, b, cin, h, w), _rand(2, cout, cin, k, k, scale=0.1), _rand(3, cout)
    got = conv.conv2d_tf32x3(x, wt, bias, s, k // 2, relu=relu)
    want = F.conv2d(x.double(), wt.double(), bias.double(), s, k // 2)
    want = F.relu(want) if relu else want
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 2e-6 * float(want.abs().max())


def _emulate(x, w, bias, relu, p):
    """y = conv(x, w) + bias (ReLU) by `conv_tf32x3_kernel`'s index
    arithmetic in float64, and the number of times each element of y is
    written. Each block (m_tile, n_tile): the loader fills the input tile
    (pixel j, 32-channel slices) from NCHW x, zero outside the image and
    past Cin; each consumer row (pixel) reads tile row hp0 + the tap's
    offset; the epilogue stores accumulator row and column to NCHW y."""
    b, c, h, wd = x.shape
    k, ks, s = w.shape[0], p.ks, p.stride
    oh, ow = conv.out_size(h, ks, s), conv.out_size(wd, ks, s)
    hw, ohw, bm = h * wd, oh * ow, 128 * p.mt
    xf = x.double().flatten()
    wf = w.double().flatten(2).permute(2, 0, 1)  # (taps, Cout, Cin)
    y = torch.zeros(b * k * ohw, dtype=torch.float64)
    writes = torch.zeros(b * k * ohw, dtype=torch.int64)
    j = torch.arange(p.hrows * p.hcols)
    ch = torch.arange(math.ceil(c / 32) * 32)
    mrow = torch.arange(bm)
    for m_tile in range(p.m_tiles):
        if ks == 3:
            r0, c0 = (m_tile // p.col_tiles) * p.th, (m_tile % p.col_tiles) * p.tw
            hbase = (r0 // oh) * p.hp + s * (r0 % oh)
            r = j // p.hcols
            prow = hbase + r
            bb = prow // p.hp
            iy, ix = prow - bb * p.hp - 1, s * c0 + (j - r * p.hcols) - 1
            ok = (bb < b) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
            off = bb * c * hw + iy * wd + ix
            tr = mrow // p.tw
            tc, rr = mrow - tr * p.tw, r0 + tr
            valid = (tr < p.th) & (rr < b * oh)
            hp0 = torch.where(valid, ((rr // oh) * p.hp + s * (rr % oh) - hbase) * p.hcols + s * tc, 0)
            ox = c0 + tc
            ok_out = valid & (ox < ow)
            off_out = (rr // oh) * k * ohw + (rr % oh) * ow + ox
        else:
            p0 = m_tile * bm
            pix = p0 + j
            bb = pix // hw
            ok, off = bb < b, bb * c * hw + (pix - bb * hw)
            hp0 = mrow
            pix = p0 + mrow
            bb = pix // ohw
            ok_out, off_out = bb < b, bb * k * ohw + (pix - bb * ohw)
        okc = ok[:, None] & (ch[None, :] < c)
        src = torch.where(okc, off[:, None] + ch[None, :] * hw, 0)
        tile = torch.where(okc, xf[src], torch.zeros((), dtype=torch.float64))
        acc = torch.zeros(bm, k, dtype=torch.float64)
        for t in range(ks * ks):
            rows = hp0 + (t // ks) * p.hcols + t % ks
            assert int(rows.max()) < p.hrows * p.hcols
            acc += tile[rows, :c] @ wf[t].T
        for n_tile in range(p.n_tiles):
            n = n_tile * p.n + torch.arange(p.n)
            n = n[n < k]
            v = acc[:, n] + (0 if bias is None else bias.double()[n])
            v = v.clamp(min=0) if relu else v
            dst = off_out[:, None] + n[None, :] * ohw
            sel = ok_out[:, None].expand_as(dst)
            y[dst[sel]] = v[sel]
            writes.index_add_(0, dst[sel], torch.ones_like(dst[sel]))
    return y.view(b, k, oh, ow), writes


# (B, Cin, H, W, Cout, k, stride, mt, n, tw): each instantiation, images
# stacked under one tile (OH < th), ragged channels, partial N tiles, tiles
# wider than the image's last columns, and the trunk's own plans at B = 2
TILES = [
    (3, 40, 5, 13, 72, 3, 1, 1, 32, 8),
    (2, 64, 20, 36, 64, 3, 1, 2, 64, 16),
    (2, 32, 9, 22, 96, 3, 1, 2, 128, 14),
    (2, 24, 8, 22, 192, 3, 1, 2, 64, 11),
    (3, 48, 4, 11, 170, 3, 1, 1, 32, 11),
    (2, 40, 6, 9, 200, 3, 1, 2, 128, 9),
    (2, 64, 17, 35, 128, 3, 2, 1, 128, 8),
    (4, 16, 6, 10, 64, 3, 2, 1, 128, 8),
    (3, 48, 7, 12, 100, 1, 1, 1, 192, 0),
    (2, 96, 11, 12, 256, 1, 1, 2, 128, 0),
    (3, 72, 5, 8, 170, 1, 1, 1, 160, 0),
    (2, 40, 6, 6, 200, 1, 1, 1, 192, 0),
    (3, 24, 5, 4, 300, 1, 1, 2, 128, 0),
]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", range(len(TILES) + len(SHAPES)))
def test_kernel_index_arithmetic(case, relu):
    """The kernel's tiling, replayed (`_emulate`), computes F.conv2d, and
    every output element is written exactly once."""
    if case < len(TILES):
        b, cin, h, w, cout, k, s, mt, n, tw = TILES[case]
        p = conv.tile_plan(b, cin, h, w, cout, k, s, mt, n, tw)
    else:
        b, cin, h, w, cout, k, s = list(SHAPES.values())[case - len(TILES)]
        p = conv.plan(b, cin, h, w, cout, k, s)
    assert p is not None and (p.mt, p.n) in conv.KERNELS[(k, s)]
    x, wt, bias = _rand(4, b, cin, h, w), _rand(5, cout, cin, k, k, scale=0.1), _rand(6, cout)
    got, writes = _emulate(x, wt, bias if relu else None, relu, p)
    want = F.conv2d(x.double(), wt.double(), bias.double() if relu else None, s, k // 2)
    want = F.relu(want) if relu else want
    assert bool((writes == 1).all())
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def _trunk_convs(b=48, h=128, w=352, name="vovnet39", stage4=True):
    """(Cin, H, W, Cout, k, stride) of every conv kernel 8 runs in
    VoVNetV2(name) at b images of h x w, in order (stage 4 with `stage4`)."""
    stem, mids, outs, layers_, blocks = TIMM_CONFIGS[name]
    convs, cin = [], 3
    for ch, s in zip(stem, (2, 1, 2)):
        if conv.takes(cin, ch, 3, s, 1, h * w):
            convs.append((cin, h, w, ch, 3, s))
        h, w, cin = conv.out_size(h, 3, s), conv.out_size(w, 3, s), ch
    for st in range(4 if stage4 else 3):
        if st > 0:
            h, w = math.ceil((h - 3) / 2) + 1, math.ceil((w - 3) / 2) + 1
        for blk in range(blocks[st]):
            c = cin
            for _ in range(layers_):
                convs.append((c, h, w, mids[st], 3, 1))
                c = mids[st]
            convs.append((cin + layers_ * mids[st], h, w, outs[st], 1, 1))
            cin = outs[st]
    return convs


def test_trunk_plans_cover_every_tile():
    """At the flagship's 48 images of 128 x 352, every conv of the train
    trunk gets a plan that fits in shared memory, whose tiles read only rows
    of their halo and together store each output pixel once; eval runs the
    first 26 of these (the stem's first conv stays on F.conv2d)."""
    convs = _trunk_convs()
    assert len(convs) == 38 and len(_trunk_convs(stage4=False)) == 26
    for cin, h, w, cout, k, s in set(convs):
        p = conv.plan(48, cin, h, w, cout, k, s)
        assert p.smem <= conv.SMEM and 2 <= p.b_stages <= conv.MAX_B_STAGES
        oh, ow = conv.out_size(h, k, s), conv.out_size(w, k, s)
        if k == 1:
            assert p.m_tiles * 128 * p.mt >= 48 * oh * ow
            continue
        m_tile = torch.arange(p.m_tiles)[:, None]
        mrow = torch.arange(128 * p.mt)[None, :]
        r0, c0 = (m_tile // p.col_tiles) * p.th, (m_tile % p.col_tiles) * p.tw
        hbase = (r0 // oh) * p.hp + s * (r0 % oh)
        tr = mrow // p.tw
        tc, rr = mrow - tr * p.tw, r0 + tr
        valid = (tr < p.th) & (rr < 48 * oh) & (c0 + tc < ow)
        rows = (rr // oh) * p.hp + s * (rr % oh) - hbase
        assert int(rows[valid].min()) >= 0 and int(rows[valid].max()) + 2 < p.hrows
        assert int((s * tc + 2).max()) < p.hcols
        pix = ((rr // oh) * oh + rr % oh) * ow + c0 + tc
        assert torch.equal(torch.sort(pix[valid]).values, torch.arange(48 * oh * ow))


@pytest.mark.parametrize("training", [False, True])
def test_plain_version_is_differentiable(training):
    """On the CPU the wrapper's plain version carries autograd: gradients of
    x, w and the bias equal F.conv2d's (the card's kernel has none and
    refuses such a call; `ConvBnAct` sends convs that need one to F.conv2d)."""
    b, cin, h, w, cout, k, s = SHAPES["3x3_stride2_ragged"]
    grads = []
    for run in ("wrapper", "conv2d"):
        x, wt = _rand(7, b, cin, h, w).requires_grad_(), _rand(8, cout, cin, k, k).requires_grad_()
        bias = _rand(9, cout).requires_grad_()
        relu = not training
        if run == "wrapper":
            y = conv.conv2d_tf32x3(x, wt, bias, s, k // 2, relu=relu)
        else:
            y = F.conv2d(x, wt, bias, s, k // 2)
            y = F.relu(y) if relu else y
        y.sum().backward()
        grads.append([x.grad, wt.grad, bias.grad])
    for a, want in zip(*grads):
        assert torch.equal(a, want)


def test_shape_rule():
    """Kernel 8 takes 3x3 convs at stride 1 and 2 (padding 1) and 1x1 convs
    (padding 0, H W a multiple of 4) with K = Cin k^2 a multiple of 8,
    groups and dilation 1; the stem's first conv (Cin 3, K 27) stays on
    F.conv2d."""
    assert conv.takes(64, 64, (3, 3), (1, 1), (1, 1), 64 * 176)
    assert conv.takes(64, 128, (3, 3), (2, 2), (1, 1), 64 * 176)
    assert conv.takes(128, 128, (3, 3), (1, 1), (1, 1), 7 * 9)
    assert conv.takes(768, 256, (1, 1), (1, 1), (0, 0), 32 * 88)
    assert conv.takes(2144, 1024, (1, 1), (1, 1), (0, 0), 4 * 11)
    assert not conv.takes(768, 256, (1, 1), (1, 1), (0, 0), 7 * 9)
    assert not conv.takes(3, 64, (3, 3), (2, 2), (1, 1), 128 * 352)
    assert not conv.takes(12, 64, (1, 1), (1, 1), (0, 0), 64)
    assert not conv.takes(64, 64, (3, 3), (1, 1), (2, 2), 64, dilation=2)
    assert not conv.takes(64, 64, (3, 3), (1, 1), (1, 1), 64, groups=64)
    assert not conv.takes(64, 64, (5, 5), (1, 1), (2, 2), 64)
    assert not conv.takes(64, 64, (1, 1), (2, 2), (0, 0), 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [False, True])
def test_conv_bn_act_routes_float32_to_the_kernel(monkeypatch, dtype, training):
    """VoVNet-39 to c3 at 64 x 128: in float32 every ConvBnAct conv that no
    gradient flows through, but the stem's first, goes through
    `conv2d_tf32x3`: the 26 of an eval forward; in training, with autograd
    on, the 12 of stage 4 alone, which runs under no_grad for its batch-norm
    statistics; in bfloat16 none. The forward equals the one with the
    routing off, bit for bit (the CPU takes the plain version)."""
    calls = []
    real = conv.conv2d_tf32x3

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    net = VoVNetV2("vovnet39").train(training)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05 + (1.0 if p.dim() == 1 else 0.0))
    x = _rand(13, 1, 3, 64, 128).to(dtype)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    monkeypatch.setattr(conv, "conv2d_tf32x3", spy)
    with torch.set_grad_enabled(training):
        got = net(x, with_c4=False)["c3"]
    assert len(calls) == (0 if dtype == torch.bfloat16 else 12 if training else 26)
    if dtype == torch.bfloat16:
        return
    net.load_state_dict(state)
    monkeypatch.setattr(layers.conv_ops, "takes", lambda *a, **k: False)
    with torch.set_grad_enabled(training):
        want = net(x, with_c4=False)["c3"]
    assert torch.equal(got, want)
