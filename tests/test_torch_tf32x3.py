"""The numerical design of the float32 tensor-core kernels, on the CPU.

The float32 FFN tail, seg head and trunk convs (`csrc/ffn_ln.cu`,
`csrc/seg_head.cu`, `csrc/conv_tf32x3.cu`) run every product as three TF32
passes, a_hi b_hi + a_lo b_hi + a_hi b_lo, with
the split of `ops/_tf32.py`. Here, without a card: the split is exact; the
three passes, emulated in plain torch (lo truncated to TF32 where the
tensor cores read it, sums in float32), are as close to a float64 product
as a float32 matmul; the kernels' float32 tolerance of 1e-4 tells three
passes from one or from a dropped cross term; and the fragment mappings the
kernels rely on (ldmatrix on a float tile, the accumulator fed back as the A
operand against W2^T's permuted K) reproduce the plain product; the trunk
conv kernel's walk over K = Cin x 9 in 32-channel slices, taps and k-steps
is as close as float32 at the trunk's depths. The card's
split is held to `split_tf32` bit for bit in `tests/test_torch_kernels_cuda.py`.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lss2_multimodal_nu_tpu_torch.ops import conv, ffn
from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh
from lss2_multimodal_nu_tpu_torch.ops._tf32 import K8_ORDER, permute_k8, split_tf32, split_tf32_rn
from test_torch_kernels_cuda import ffn_low_bits_inputs, seg_head_low_bits_inputs

TOL = 1e-4  # the float32 kernels' tolerance (chip_smoke.py, the card tests)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _trunc(t):
    """t as the tensor cores read a float32 operand in TF32: the low 13 bits
    of the mantissa dropped."""
    return (_bits(t) & -0x2000).view(torch.float32)


def _values(kind, rng):
    if kind == "random":
        return rng.normal(size=4096)
    if kind == "tiny":  # subnormal and the smallest normals
        return rng.normal(size=4096) * 10.0 ** rng.uniform(-45, -36, 4096)
    if kind == "huge":  # short of rounding to infinity
        return rng.normal(size=4096) * 10.0 ** rng.uniform(30, 37, 4096)
    if kind == "negative":
        return -np.abs(rng.normal(size=4096)) * 10.0 ** rng.uniform(-20, 20, 4096)
    # halfway between two TF32 values: ties go away from zero
    hi = _trunc(torch.from_numpy(rng.normal(size=4096).astype(np.float32))).numpy()
    half = (_bits(torch.from_numpy(hi)) | 0x1000).view(torch.float32).numpy()
    return half


@pytest.mark.parametrize("kind", ["random", "tiny", "huge", "negative", "ties"])
def test_split_tf32_is_exact(kind):
    """hi + lo == t exactly in float32 (as values: -0.0 splits into -0.0 and
    +0.0), hi has its low 13 mantissa bits clear, and hi is the nearest TF32
    value (ties away from zero): |lo| at most half the TF32 spacing at t,
    and exactly half only at a tie, where |hi| > |t|."""
    t = torch.from_numpy(_values(kind, np.random.default_rng(0)).astype(np.float32))
    hi, lo = split_tf32(t)
    assert torch.equal(hi + lo, t)
    assert bool((_bits(hi) & 0x1FFF == 0).all())
    exp = (_bits(t) >> 23) & 0xFF
    ulp = torch.ldexp(torch.ones_like(t, dtype=torch.float64), torch.clamp(exp, min=1) - 127 - 10)
    err = lo.double().abs()
    assert bool((err <= ulp / 2).all())
    if kind == "ties":
        assert bool((err == ulp / 2).all()) and bool((hi.abs() > t.abs()).all())


def _mm3(a, b):
    """a @ b as the float32 kernels compute it: three TF32 passes, lo
    truncated as the tensor cores read it, sums in float32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return ah @ bh + _trunc(al) @ bh + ah @ _trunc(bl)


@pytest.mark.parametrize("k", [256, 1024])
def test_three_passes_match_float64(k):
    """At the FFN's depths, (256 x k) @ (k x 256) of normal values: the three
    passes within 2e-6 of the largest float64 output (measured 6.8e-7 at
    256 and 5.0e-7 at 1024, as close as a float32 matmul's 5.7e-7 and
    4.6e-7); one pass of rounded operands misses it over 100-fold (3.1e-4
    and 2.8e-4)."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((256, k), (k, 256)))
    want = a.double() @ b.double()
    scale = float(want.abs().max())
    err = lambda got: float((got.double() - want).abs().max()) / scale
    assert err(_mm3(a, b)) <= 2e-6
    assert err(a @ b) <= 2e-6
    assert err(split_tf32(a)[0] @ split_tf32(b)[0]) > 100 * 2e-6


# How a kernel could run a product on the tensor cores, (a, b) -> a @ b.
def _one_pass_truncated(a, b):  # float32 fed to TF32 as it is
    return _trunc(a) @ _trunc(b)


def _one_pass(a, b):  # the three-pass kernel without its lo passes
    return split_tf32(a)[0] @ split_tf32(b)[0]


def _no_a_lo(a, b):
    (ah, _), (bh, bl) = split_tf32(a), split_tf32(b)
    return ah @ bh + ah @ _trunc(bl)


def _no_b_lo(a, b):
    (ah, al), (bh, _) = split_tf32(a), split_tf32(b)
    return ah @ bh + _trunc(al) @ bh


PRODUCTS = {"three_passes": _mm3, "one_pass_truncated": _one_pass_truncated,
            "one_pass": _one_pass, "no_a_lo_b_hi": _no_a_lo, "no_a_hi_b_lo": _no_b_lo}


def _ffn_emulated(u, w1, b1, w2, b2, s1, o1, s2, o2, mm):
    """`fused_ffn_ln_plain`'s float32 arithmetic with its products by `mm`."""
    s = ffn._ln(u, s1, o1, 1e-6)
    y = mm(F.gelu(mm(s, w1) + b1), w2) + b2
    return ffn._ln(s + y, s2, o2, 1e-6)


def _seg_head_emulated(x, w0, b0, w1, b1, w2, b2, h, w, mm):
    """`fused_seg_head_plain`'s float32 arithmetic with the convs' products
    by `mm`, as im2col matrix products over the 9 taps."""
    def conv(img, k, bias):  # img (B, C, h, w), k HWIO
        cols = F.unfold(img, 3, padding=1).transpose(1, 2)  # (B, hw, C*9), C slowest
        kk = k.permute(2, 0, 1, 3).reshape(-1, k.shape[3])
        out = mm(cols.reshape(-1, cols.shape[2]), kk) + bias
        return F.relu(out).reshape(img.shape[0], h, w, -1).permute(0, 3, 1, 2)

    y = conv(conv(sh._img(x, h, w), w0, b0), w1, b1)
    return torch.einsum("bchw,co->bohw", y, w2) + b2[:, None, None]


def _smoke_scale_ffn():
    """512 rows at chip_smoke.py's scales, from a numpy seed."""
    rng = np.random.default_rng(0)
    g = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    return g(512, 256), [g(256, 1024, scale=0.05), g(1024, scale=0.1), g(1024, 256, scale=0.05),
                         g(256, scale=0.1), 1 + g(256, scale=0.1), g(256, scale=0.1),
                         1 + g(256, scale=0.1), g(256, scale=0.1)]


def _case(name):
    if name == "ffn_smoke_scales":
        u, args = _smoke_scale_ffn()
    elif name == "ffn_card_hard_case":
        u, args = ffn_low_bits_inputs("cpu")
    else:
        x, wts, (h, w) = seg_head_low_bits_inputs("cpu")
        return (lambda mm: _seg_head_emulated(x, *wts, h, w, mm),
                sh.fused_seg_head_plain(x, *wts, h, w))
    return (lambda mm: _ffn_emulated(u, *args, mm),
            ffn.fused_ffn_ln_plain(u, *args, eps=1e-6, compute_dtype=torch.float32))


# (case, products) -> least factor by which the error must exceed TOL; 0 for
# three passes, which must stay within TOL / 10. Measured error / TOL (this
# file's emulation, CPU): FFN at the smoke's scales, three passes 0.0056,
# one pass truncated 9.07, one pass 2.84, no a_lo b_hi 1.94, no a_hi b_lo
# 2.00; the card tests' hard FFN case 0.0051, 7.15, 3.92, 1.90, 3.44; their
# hard seg-head case 0.0135, 12.38, 6.48, 3.11, 6.37. The floors are about
# three quarters of those.
MARGINS = {
    "ffn_smoke_scales": {"three_passes": 0, "one_pass_truncated": 6, "one_pass": 2,
                         "no_a_lo_b_hi": 1.4, "no_a_hi_b_lo": 1.5},
    "ffn_card_hard_case": {"three_passes": 0, "one_pass_truncated": 5, "one_pass": 3,
                           "no_a_lo_b_hi": 1.4, "no_a_hi_b_lo": 2.5},
    "seg_head_card_hard_case": {"three_passes": 0, "one_pass_truncated": 9, "one_pass": 5,
                                "no_a_lo_b_hi": 2.3, "no_a_hi_b_lo": 4.8},
}


@pytest.mark.parametrize("case", list(MARGINS))
@pytest.mark.parametrize("products", list(PRODUCTS))
def test_tolerance_tells_three_passes_from_fewer(case, products):
    """The float32 kernels' 1e-4 (max error over max |plain|) holds three
    passes and fails one pass (rounded or truncated) and either dropped
    cross term, by the margins in MARGINS: at the smoke's FFN scales and at
    the hard cases of the card tests (inputs ~1e3, weights whose lo parts
    are 0.45 of a TF32 ulp)."""
    run, want = _case(case)
    err = float((run(PRODUCTS[products]) - want).abs().max()) / float(want.abs().max())
    margin = MARGINS[case][products]
    if margin == 0:
        assert err <= TOL / 10, err
    else:
        assert err > margin * TOL, err


@pytest.mark.parametrize("mapping", ["ldmatrix_float_tile", "accumulator_to_a_k8_order"])
def test_fragment_mapping(mapping):
    """The two register mappings of the float32 kernels, lane by lane, for
    one warp's 16 rows (the TF32 A fragment: a0 (l/4, l%4), a1 (l/4 + 8,
    l%4), a2 (l/4, l%4 + 4), a3 (l/4 + 8, l%4 + 4) of each 8-wide k-step).
    ldmatrix.x4 with lane l addressing row l%16 and 16-byte chunk 2k + l/16
    of a float tile, thread l taking word (l/4, l%4) of each 8 x 4 matrix,
    gives that fragment. The accumulator (d_i of lane l at row l/4 + 8
    ((i/2)%2), column 8 (i/4) + 2 (l%4) + i%2) fed back as a = {d0, d2, d1,
    d3} of each k-step, against B's K axis permuted by K8_ORDER, gives the
    product of the unpermuted operands exactly (integer values in float64);
    without the permutation it does not."""
    rng = np.random.default_rng(2)
    lanes = np.arange(32)
    r, t = lanes // 4, lanes % 4
    if mapping == "ldmatrix_float_tile":
        tile = rng.normal(size=(16, 32))
        for ks in range(4):
            addr_row, addr_chunk = lanes % 16, 2 * ks + lanes // 16  # lane 8j + i: row i of matrix j
            got = [tile[addr_row[8 * j + r], 4 * addr_chunk[8 * j + r] + t] for j in range(4)]
            want = [tile[r, 8 * ks + t], tile[r + 8, 8 * ks + t],
                    tile[r, 8 * ks + t + 4], tile[r + 8, 8 * ks + t + 4]]
            for a, b in zip(got, want):
                assert np.array_equal(a, b)
        return
    h = rng.integers(-8, 8, size=(16, 64)).astype(np.float64)
    w2 = rng.integers(-8, 8, size=(64, 24)).astype(np.float64)
    for order in (K8_ORDER, tuple(range(8))):
        w2t = permute_k8(torch.from_numpy(w2.T.copy())).numpy() if order == K8_ORDER else w2.T
        y = np.zeros((16, 24))
        for kk in range(8):
            a = np.zeros((16, 8))
            regs = [h[r + 8 * ((i // 2) % 2), 8 * kk + 2 * t + i % 2] for i in range(4)]
            a0, a1, a2, a3 = regs[0], regs[2], regs[1], regs[3]  # a = {d0, d2, d1, d3}
            a[r, t], a[r + 8, t], a[r, t + 4], a[r + 8, t + 4] = a0, a1, a2, a3
            y += a @ w2t[:, 8 * kk:8 * kk + 8].T
        assert np.array_equal(y, h @ w2) == (order == K8_ORDER)


def _conv_k_walk(a, ws, cross=True):
    """Kernel 8's sum over K for a block of pixels: a (P, taps, Cin) the
    pixels' inputs at each tap, ws (2, taps, Cout, Cin) the split weight;
    32-channel slices (zeros past Cin), then taps; each (slice, tap) item's
    partial sum takes the cross terms a_lo w_hi + a_hi w_lo of its 8-wide
    k-steps (unless not `cross`), then a_hi w_hi of each (a split by
    `split_tf32_rn`), and is added to the float32 accumulator."""
    p, taps, cin = a.shape
    acc = torch.zeros(p, ws.shape[2])
    for s in range(0, cin, 32):
        for t in range(taps):
            part = torch.zeros_like(acc)
            steps = [(split_tf32_rn(a[:, t, k:k + 8]), ws[:, t, :, k:k + 8].transpose(1, 2))
                     for k in range(s, min(s + 32, cin), 8)]
            for (ah, al), (wh, wl) in steps:
                if cross:
                    part += al @ wh
                    part += ah @ wl
            for (ah, _), (wh, _) in steps:
                part += ah @ wh
            acc += part
    return acc


@pytest.mark.parametrize("cin,k", [(128, 3), (224, 3), (1024, 3), (2144, 1)])
def test_conv_k_tiling_three_passes(cin, k):
    """Kernel 8's product over K = Cin k^2 walked as the kernel walks it,
    with the weight split as it reads it ((2, taps, Cout, Cin),
    `conv.tf32_split_weight_plain`: lo rounded to TF32, so hi + lo is the
    weight to 2^-22 and the tensor cores read both exactly), at the trunk's
    depths from stage 1's 3x3 (K 1152) to stage 4's widest concat (K 2144):
    within 2e-6 of float64's largest output, as a float32 product is; one
    TF32 pass misses by over 100x."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(np.maximum(rng.normal(size=(64, k * k, cin)), 0).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(96, cin, k, k)) * np.sqrt(2.0 / (cin * k * k)))
                         .astype(np.float32))
    ws = conv.tf32_split_weight_plain(w)
    wt = w.flatten(2).permute(2, 0, 1)
    assert ws.shape == (2, k * k, 96, cin)
    assert torch.equal(ws[0], split_tf32(wt)[0]) and torch.equal(ws[1], _trunc(ws[1]))
    assert bool(((ws[0].double() + ws[1].double() - wt.double()).abs()
                 <= 2.0 ** -22 * wt.double().abs()).all())
    want = torch.einsum("ptc,tnc->pn", a.double(), wt.double())
    scale = float(want.abs().max())
    err = lambda got: float((got.double() - want).abs().max()) / scale
    assert err(_conv_k_walk(a, ws)) <= 2e-6
    assert err(_conv_k_walk(a, ws, cross=False)) > 100 * 2e-6
