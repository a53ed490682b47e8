"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes that the flagship's (all multiples of the kernels' tiles)
never reach: partial query, row and pixel tiles, channel counts that are
no multiple of a warp, non-square maps, and the deformable kernels at the
edges of their query tiles and lane groups (and their refusal of a dh that
is no multiple of 8); the deformable backward also with every location in
one cell and with the cotangent scaled by 2^-20 and 2^20, and bit for bit
on repeat everywhere. The float32 FFN tail and seg head, which run in three
TF32 passes, also at inputs of magnitude ~1e3 with weights whose TF32 lo
parts are near their largest, where one pass would miss the tolerance, and
their weights' split bit for bit against `ops/_tf32.py`. The lift-splat
forward and backward with a voxel of 5000 points and a feature row of none,
repeated bit for bit, their index preparation against the CPU's, their
refusal of rows that are no whole number of 16-byte slices, and no host
sync in a second call; both again at Stack A's width, C=64 (B=1 and 3, a
voxel of one point, no live point at all), and through `lift_splat` with
C=64 and C=128 alternating on the frustum's one cached CSR. The data
slice's kernels bit for bit against their plain versions: the JPEG IDCT at
odd sizes mixing 4:2:0, 4:4:4 and gray, the augmentation over train and eval
draws, the C++ entropy decoder against the Python one, and the loader on the
card against the CPU with no host sync in its device stage. Plus the whole
flagship in float32 on the card against the CPU at a 30x30 BEV grid, in
eval and for one train step with its gradients, with TF32 turned off by the
caller and under torch's defaults, and its train step twice from one state,
bit for bit; one flagship bf16 and one train-v2 f32 step at full width
under `torch.use_deterministic_algorithms` (`scripts/port_determinism.py`),
which must flag no operation; and Stack A's BevTxt at B=1 on the card
against the CPU.

Marked `cuda`; each test skips without a card. On the card, without JAX
(this file imports none, and the suite's conftest imports JAX):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances are those of `chip_smoke.py`, relative to the plain output's
largest magnitude: float32 1e-5 for the gathers and the scatter (sum
order), 1e-4 for the matrix-product kernels; bfloat16 one ulp (2^-7), or
two (2^-6) where the kernel rounds an intermediate to bf16; the lift-splat
backward's ddepth, float32 in both dtypes, 1e-5."""
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu_torch.config import AugConfig, Config, GridConfig, ModelConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
from lss2_multimodal_nu_tpu_torch.ops import ffn
from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh
from lss2_multimodal_nu_tpu_torch.ops._tf32 import split_tf32
from lss2_multimodal_nu_tpu_torch.train import state as ts
from lss2_multimodal_nu_tpu_torch.train import steps as tsteps

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.fixture
def dev_defaults():
    """The card under torch's default cuDNN flag (TF32 allowed) and the
    matrix-product precision "high" (TF32 allowed) that training scripts often
    set: the port pins full float32 itself (`ops/_precision.py`), and leaves
    the flags as it found them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield torch.device("cuda", 0)
    flags = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = old[0]
    torch.set_float32_matmul_precision(old[1])
    assert flags == (True, "high")


# the two ways the whole-model checks run: TF32 turned off by the caller, and
# torch's defaults with matrix products at "high"
FLAGS = ["tf32_off", "torch_defaults_matmul_high"]


def _card(request, flags):
    return request.getfixturevalue({"tf32_off": "dev",
                                    "torch_defaults_matmul_high": "dev_defaults"}[flags])


def _rng_tensors(dev, seed):
    rng = np.random.default_rng(seed)
    g = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)).to(dev)
    u = lambda *s: torch.from_numpy(rng.uniform(0, 1, size=s).astype(np.float32)).to(dev)
    return rng, g, u


def _check(kernel, plain, tol, counter):
    before = counter.launches
    got = kernel()
    torch.cuda.synchronize()
    assert counter.launches > before
    ref = plain()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    ref = ref.float()
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 48])
def test_deformable_ragged(dev, dtype, dh):
    """63 queries (a partial block of 8), a 7x9 map, 5 points."""
    _, g, u = _rng_tensors(dev, 1)
    bh, h, w, npts = 3, 7, 9, 5
    v = g(bh, h * w, dh).to(dtype)
    lx, ly = (torch.clamp(u(bh, npts, h * w) * 1.2 - 0.1, 0, 1) for _ in range(2))
    attn = torch.softmax(g(bh, npts, h * w), dim=1)
    f = ds.deformable_sample_combine_xy
    _check(lambda: f(v, lx, ly, attn, h, w),
           lambda: ds.deformable_sample_combine_xy_plain(v, lx, ly, attn, h, w),
           1e-5 if dtype == torch.float32 else 2 ** -7, f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 48])
def test_deformable_backward_ragged(dev, dtype, dh):
    """Kernel 2 on a 7x9 map with 63 queries (a partial block of 8), 5
    points, dh 32 and 48 (a second, partial pass of the lanes), many
    samples clamped to the edges. The tolerances of chip_smoke.py: dv 5e-5
    (float32 sums in another order than the plain version's) or 2^-6
    (bfloat16, rounded once); dlx, dly, dattn are float32 in both dtypes,
    1e-4, for rc_01 - rc_00 cancels. A second call gives the same bits."""
    _, g, u = _rng_tensors(dev, 6)
    bh, h, w, npts = 3, 7, 9, 5
    v = g(bh, h * w, dh).to(dtype)
    cot = g(bh, h * w, dh).to(dtype)
    lx, ly = (torch.clamp(u(bh, npts, h * w) * 1.2 - 0.1, 0, 1) for _ in range(2))
    attn = torch.softmax(g(bh, npts, h * w), dim=1)
    _check_backward_deform((v, lx, ly, attn), cot, h, w)


def _check_backward_deform(args, cot, h, w):
    """Kernel 2 on (v, lx, ly, attn) and the cotangent: one launch, each
    output within its tolerance of the plain version's (those of
    `test_deformable_backward_ragged`), and a second call bit for bit."""
    f = ds.deformable_sample_combine_xy_backward
    before = f.launches
    got = f(*args, cot, h, w)
    again = f(*args, cot, h, w)
    torch.cuda.synchronize()
    assert f.launches == before + 2
    want = ds.deformable_sample_combine_xy_backward_plain(*args, cot, h, w)
    tols = (5e-5 if args[0].dtype == torch.float32 else 2 ** -6, 1e-4, 1e-4, 1e-4)
    for name, a, b, tol, a2 in zip(("dv", "dlx", "dly", "dattn"), got, want, tols, again):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)
        assert torch.equal(a, a2), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,n", [((7, 9), 63), ((8, 8), 65), ((1, 1), 3)])
def test_deformable_backward_one_cell(dev, dtype, hw, n):
    """Kernel 2 with every location in one cell, so that the cell's bucket
    (8 points x n queries, 24 to 520 of them) is longer than a lane group
    walks alone (`ops/deformable_sampling.py::DV_CHUNK`) or not, and its
    points go to four dv rows in pieces: within tolerance, bit for bit on
    repeat, every other dv row zero."""
    _, g, u = _rng_tensors(dev, 21)
    (h, w), bh, npts, dh = hw, 3, 8, 32
    v = g(bh, h * w, dh).to(dtype)
    lx = (w // 2 + 0.5 + 0.02 + 0.96 * u(bh, npts, n)) / w
    ly = (h // 3 + 0.5 + 0.02 + 0.96 * u(bh, npts, n)) / h
    if h == 1:  # the one cell of a 1x1 map: corner 00 at (0, 0), the others outside
        lx, ly = (0.5 + 0.02 + 0.96 * u(bh, npts, n)) / w, (0.5 + 0.02 + 0.96 * u(bh, npts, n)) / h
    attn = torch.softmax(g(bh, npts, n), dim=1)
    _check_backward_deform((v, lx, ly, attn), g(bh, n, dh).to(dtype), h, w)
    dv = ds.deformable_sample_combine_xy_backward(v, lx, ly, attn, g(bh, n, dh).to(dtype), h, w)[0]
    touched = {(h // 3 + dy) * w + w // 2 + dx for dy in (0, 1) for dx in (0, 1)
               if h // 3 + dy < h and w // 2 + dx < w}
    rest = [r for r in range(h * w) if r not in touched]
    assert not rest or not bool(dv[:, rest].any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [2.0 ** -20, 2.0 ** 20])
def test_deformable_backward_scaled_cotangent(dev, dtype, scale):
    """dv keeps its tolerance with the cotangent scaled by 2^-20 and 2^20: it
    is summed in float32, as the JAX kernel's is, with no rounding to a grid
    set by the largest contribution (as integer fixed-point sums would)."""
    _, g, u = _rng_tensors(dev, 22)
    bh, h, w, npts, dh = 2, 9, 8, 8, 32
    v = g(bh, h * w, dh).to(dtype)
    lx, ly = (torch.clamp(u(bh, npts, h * w) * 1.2 - 0.1, 0, 1) for _ in range(2))
    attn = torch.softmax(g(bh, npts, h * w), dim=1)
    _check_backward_deform((v, lx, ly, attn), (g(bh, h * w, dh) * scale).to(dtype), h, w)


def test_deformable_function_launches_both_kernels(dev):
    """Autograd through `deformable_sample_combine_xy` on the card: one
    forward and one backward launch, and gradients on all four inputs equal
    to the explicit backward's."""
    _, g, u = _rng_tensors(dev, 7)
    bh, h, w, npts, dh = 2, 6, 5, 4, 32
    leaves = [g(bh, h * w, dh), u(bh, npts, h * w), u(bh, npts, h * w),
              torch.softmax(g(bh, npts, h * w), dim=1)]
    leaves = [t.requires_grad_() for t in leaves]
    cot = g(bh, h * w, dh)
    counters = (ds.deformable_sample_combine_xy, ds.deformable_sample_combine_xy_backward)
    before = [c.launches for c in counters]
    (ds.deformable_sample_combine_xy(*leaves, h, w) * cot).sum().backward()
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    want = ds.deformable_sample_combine_xy_backward_plain(*[t.detach() for t in leaves], cot, h, w)
    for leaf, b in zip(leaves, want):
        assert float((leaf.grad - b).abs().max()) <= 1e-4 * float(b.abs().max())


# The deformable kernels serve a query with a group of lanes, each owning 16
# bytes of its dh channels (4 lanes in bf16 at dh=32, 5 at dh=40, 8 in
# float32), and a block of 256 threads with a tile of the query grid 8
# queries wide, whose rows hold w queries: 8x8 queries in bf16 at dh=32, the
# main path's. (h, w, n) at that tile's edges:
DEFORM_EDGES = {
    "one_query": (7, 9, 1),
    "tile_minus_1": (8, 8, 63),
    "tile_plus_1": (9, 8, 65),
    "ragged_last_warp": (8, 8, 61),  # 5 of the last warp's 8 queries
    "width_off_tile": (6, 13, 78),   # a tile of 8 columns and one of 5
}


def _deform_edge_inputs(dev, dtype, edge, npts, dh, seed):
    """v, lx, ly, attn and a cotangent at `edge`, a fifth of the locations
    exactly 0 and a fifth exactly 1, so that corners fall outside the map."""
    rng, g, _ = _rng_tensors(dev, seed)
    h, w, n = DEFORM_EDGES[edge]
    bh = 2

    def locations():
        r = rng.uniform(0, 1, (bh, npts, n))
        loc = np.where(r < 0.2, 0.0, np.where(r < 0.4, 1.0, rng.uniform(0, 1, r.shape)))
        return torch.from_numpy(loc.astype(np.float32)).to(dev)

    v = g(bh, h * w, dh).to(dtype)
    lx, ly = locations(), locations()
    attn = torch.softmax(g(bh, npts, n), dim=1)
    return (h, w), (v, lx, ly, attn), g(bh, n, dh).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 40, 48])
@pytest.mark.parametrize("npts", [1, 5, 8])
@pytest.mark.parametrize("edge", list(DEFORM_EDGES))
def test_deformable_edges(dev, dtype, dh, npts, edge):
    """Kernel 1 at the edges of its tiles and lane groups: 1, 63, 65 and 61
    queries, a width off the tile's, npts 1 and 5 (the generic kernel) and 8
    (its own instance), dh 32, 40 and 48, locations exactly 0 and 1."""
    (h, w), args, _ = _deform_edge_inputs(dev, dtype, edge, npts, dh, 11)
    f = ds.deformable_sample_combine_xy
    _check(lambda: f(*args, h, w), lambda: ds.deformable_sample_combine_xy_plain(*args, h, w),
           1e-5 if dtype == torch.float32 else 2 ** -7, f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 40, 48])
@pytest.mark.parametrize("npts", [1, 5, 8])
@pytest.mark.parametrize("edge", list(DEFORM_EDGES))
def test_deformable_backward_edges(dev, dtype, dh, npts, edge):
    """Kernel 2 at the cases of `test_deformable_edges`, each of its four
    outputs at the tolerances of `test_deformable_backward_ragged` and bit
    for bit on repeat."""
    (h, w), args, cot = _deform_edge_inputs(dev, dtype, edge, npts, dh, 12)
    _check_backward_deform(args, cot, h, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("npts", [5, 8])
def test_deformable_rows_wider_than_a_warp(dev, dtype, npts):
    """dh=264: 33 slices of 16 bytes in bf16 and 66 in float32, more than
    a warp's 32 lanes, so each lane serves a query (or a dv row) in 2 or 3
    passes. Both kernels against their plain versions at the tolerances
    above, the backward bit for bit on repeat."""
    (h, w), args, cot = _deform_edge_inputs(dev, dtype, "tile_plus_1", npts, 264, 14)
    f = ds.deformable_sample_combine_xy
    bf = dtype == torch.bfloat16
    _check(lambda: f(*args, h, w), lambda: ds.deformable_sample_combine_xy_plain(*args, h, w),
           2 ** -7 if bf else 1e-5, f)
    _check_backward_deform(args, cot, h, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deformable_dh_off_16_bytes_raises(dev, dtype):
    """dh=36 is no multiple of 8, so a row is no whole number of 16-byte
    slices: both wrappers raise on the card, launch nothing and do not fall
    back to the plain versions."""
    (h, w), (v, lx, ly, attn), _ = _deform_edge_inputs(dev, dtype, "tile_minus_1", 5, 40, 13)
    v = v[..., :36].contiguous()
    cot = torch.zeros(v.shape[0], lx.shape[2], 36, dtype=dtype, device=dev)
    counters = (ds.deformable_sample_combine_xy, ds.deformable_sample_combine_xy_backward)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="multiple of 8"):
        ds.deformable_sample_combine_xy(v, lx, ly, attn, h, w)
    with pytest.raises(ValueError, match="multiple of 8"):
        ds.deformable_sample_combine_xy_backward(v, lx, ly, attn, cot, h, w)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_lift_splat_ragged(dev, dtype):
    """C=40 (5 or 10 slices of 16 bytes: a lane group of 8 or 16 with idle
    lanes), 1001 points (no multiple of a lane group)."""
    rng, g, u = _rng_tensors(dev, 2)
    b, r, p, c, nv = 2, 17, 1001, 40, 50
    feat = g(b, r, c).to(dtype)
    depth = u(b, p) * (u(b, p) > 0.3)
    seg = torch.from_numpy(rng.integers(0, nv, (b, p)).astype(np.int32)).to(dev)
    fidx = torch.from_numpy(rng.integers(0, r, (b, p)).astype(np.int32)).to(dev)
    f = ls.fused_lift_splat
    _check(lambda: f(feat, depth, seg, fidx, nv),
           lambda: ls.fused_lift_splat_plain(feat, depth, seg, fidx, nv),
           1e-5 if dtype == torch.float32 else 2 ** -7, f)


def _splat_operands(dev, dtype, c, seed=3, p=1001, crowd=5000):
    """Lift-splat operands with 30% depth-0 points (seg 0, as `lift_splat`
    prepares them), a point count off every lane group, one voxel (3) that
    takes `crowd` more points, feature row 4 that no point reads, and a
    cotangent g of the output."""
    rng, g, u = _rng_tensors(dev, seed)
    b, r, nv = 2, 17, 50
    p_all = p + crowd
    depth = u(b, p_all) * (u(b, p_all) > 0.3)
    seg = torch.from_numpy(rng.integers(0, nv, (b, p_all)).astype(np.int32)).to(dev)
    seg[:, p:] = 3
    seg = torch.where(depth != 0, seg, 0)
    fidx = torch.from_numpy(rng.integers(0, r, (b, p_all)).astype(np.int32)).to(dev)
    fidx = torch.where(fidx == 4, 5, fidx)
    return g(b, r, c).to(dtype), depth, seg, fidx, nv, g(b, nv, c).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [40, 128])
def test_lift_splat_crowded_voxel(dev, dtype, c):
    """The forward with one voxel of 5000 points (a run of 157 lane groups'
    worth at C=128 in float32), against its plain version."""
    feat, depth, seg, fidx, nv, _ = _splat_operands(dev, dtype, c)
    f = ls.fused_lift_splat
    _check(lambda: f(feat, depth, seg, fidx, nv),
           lambda: ls.fused_lift_splat_plain(feat, depth, seg, fidx, nv),
           1e-5 if dtype == torch.float32 else 2 ** -7, f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [40, 128])
def test_lift_splat_backward_matches_plain(dev, dtype, c):
    """The backward kernel against its plain version: dfeat to 1e-5 in
    float32 (sums in another order) and 2^-7 in bfloat16 (rounded once at
    the end, where the order may flip the rounding: one ulp); ddepth, float32
    in both dtypes, to 1e-5 (a dot product of C terms in another order). The
    depth-0 points get their ddepth too, and feature row 4, which no point
    reads, a zero dfeat."""
    feat, depth, seg, fidx, nv, cot = _splat_operands(dev, dtype, c)
    f = ls.fused_lift_splat_backward
    before = f.launches
    dfeat, ddepth = f(feat, depth, seg, fidx, cot)
    torch.cuda.synchronize()
    assert f.launches == before + 1
    want_feat, want_depth = ls.fused_lift_splat_backward_plain(feat, depth, seg, fidx, cot)
    tol_feat = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, a, b, tol in (("dfeat", dfeat, want_feat, tol_feat),
                            ("ddepth", ddepth, want_depth, 1e-5)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)
    assert bool((dfeat[:, 4] == 0).all()) and bool((ddepth[depth == 0] != 0).all())


def test_lift_splat_function_launches_both_kernels(dev):
    """Autograd through `fused_lift_splat` on the card: one forward and one
    backward launch, and gradients equal to the explicit backward's bit for
    bit (the same kernel), with the CSR over fidx built in the backward and
    passed in."""
    feat, depth, seg, fidx, nv, cot = _splat_operands(dev, torch.float32, 40, crowd=40)
    leaves = [feat.requires_grad_(), depth.requires_grad_()]
    counters = (ls.fused_lift_splat, ls.fused_lift_splat_backward)
    want = ls.fused_lift_splat_backward(feat.detach(), depth.detach(), seg, fidx, cot)
    csr = ls.sort_points(fidx, None, feat.shape[1])
    for kw in ({}, {"_fidx_csr": csr}):
        before = [c.launches for c in counters]
        (ls.fused_lift_splat(feat, depth, seg, fidx, nv, **kw) * cot).sum().backward()
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [b + 1 for b in before]
        for leaf, b in zip(leaves, want):
            assert torch.equal(leaf.grad, b)
            leaf.grad = None


@pytest.mark.parametrize("dtype", DTYPES)
def test_lift_splat_repeats_bit_for_bit(dev, dtype):
    """Forward and backward, twice each on the same inputs, with thousands
    of points in one voxel: equal bit for bit (no atomics; the stable sort
    fixes every sum's order)."""
    feat, depth, seg, fidx, nv, cot = _splat_operands(dev, dtype, 128, seed=8)
    outs = [ls.fused_lift_splat(feat, depth, seg, fidx, nv) for _ in range(2)]
    grads = [ls.fused_lift_splat_backward(feat, depth, seg, fidx, cot) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_sort_points_card_matches_cpu(dev):
    """The card's keys kernel, stable sort and row offsets against the CPU
    version (which `tests/test_torch_lift_splat.py` holds against numpy),
    bit for bit, with and without weights."""
    feat, depth, seg, fidx, nv, _ = _splat_operands(dev, torch.float32, 40)
    for row, weight, n in ((seg, depth, nv), (fidx, None, feat.shape[1])):
        got = ls.sort_points(row, weight, n)
        want = ls.sort_points(row.cpu(), None if weight is None else weight.cpu(), n)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 36), (torch.float32, 6)])
def test_lift_splat_refuses_rows_off_16_bytes(dev, dtype, c):
    """Rows that are no whole number of 16-byte slices raise before any
    launch, forward and backward."""
    feat, depth, seg, fidx, nv, cot = _splat_operands(dev, dtype, c, crowd=10)
    counters = (ls.fused_lift_splat, ls.fused_lift_splat_backward)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="16-byte"):
        ls.fused_lift_splat(feat, depth, seg, fidx, nv)
    with pytest.raises(ValueError, match="16-byte"):
        ls.fused_lift_splat_backward(feat, depth, seg, fidx, cot)
    assert [f.launches for f in counters] == before


def test_lift_splat_makes_no_host_sync(dev):
    """After a first call (which builds the kernels and caches the frustum's
    constants), a lift-splat forward and backward, and a whole
    `model.lift_to_bev`, run under `cuda.set_sync_debug_mode("error")`: a
    host sync (a pageable copy, an `.item()`) would raise."""
    feat, depth, seg, fidx, nv, cot = _splat_operands(dev, torch.bfloat16, 128)
    feat.requires_grad_()
    _, card = _small_models(dev)
    args = [a.to(dev) for a in _camera_args()]
    with torch.no_grad():
        c3, c4 = card.encode_cameras(args[0])

    def run():
        (ls.fused_lift_splat(feat, depth, seg, fidx, nv) * cot).sum().backward()
        with torch.no_grad():
            return card.lift_to_bev(c3, c4, *args[1:])

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bev = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(bev).all())


# A full wave of both FFN kernels' 128-row blocks: one per SM of an H100.
WAVE = 132 * 128


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n", [(2, 77), (1, 1), (1, 63), (1, 64), (1, 65), (1, 127), (1, 128),
                                 (1, 129), (1, WAVE - 1), (1, WAVE), (1, WAVE + 1),
                                 (1, WAVE + 77)])
def test_ffn_ragged(dev, dtype, b, n):
    """Row counts at the edges of both kernels' 128-row blocks and their
    64-row warpgroup halves: 154 rows in two batches, 1, 63, 64, 65, 127,
    128, 129, a full wave of blocks and one row either side, and more blocks
    than the card has SMs."""
    _, g, _ = _rng_tensors(dev, 3)
    u = g(b, n, 256).to(dtype)
    args = (g(256, 1024, scale=0.05), g(1024, scale=0.1), g(1024, 256, scale=0.05),
            g(256, scale=0.1), 1 + g(256, scale=0.1), g(256, scale=0.1), 1 + g(256, scale=0.1),
            g(256, scale=0.1))
    f = ffn.fused_ffn_ln
    _check(lambda: f(u, *args, eps=1e-6, compute_dtype=dtype),
           lambda: ffn.fused_ffn_ln_plain(u, *args, eps=1e-6, compute_dtype=dtype),
           1e-4 if dtype == torch.float32 else 2 ** -6, f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nout", [3, 4])
@pytest.mark.parametrize("b,h,w", [(2, 9, 13), (2, 1, 1), (1, 17, 203), (1, 200, 200),
                                   (1, 16, 16), (1, 15, 17), (1, 33, 31)])
def test_seg_head_ragged(dev, dtype, nout, b, h, w):
    """Maps at and off the 16 x 16 pixel tiles of both dtypes: 9 x 13 (every
    row near a border), a single pixel (every tap but the centre reads the
    padding), 17 x 203 (partial tiles both ways), the flagship's 200 x 200
    at B=1, one whole tile, 15 x 17 (one short, one over) and 33 x 31 (a
    third tile of one row); 3 and 4 output classes; both launches."""
    _, g, _ = _rng_tensors(dev, 4)
    x = g(b, h * w, 256, scale=0.5).to(dtype)
    wts = (g(3, 3, 256, 128, scale=0.03), g(128, scale=0.1), g(3, 3, 128, 64, scale=0.04),
           g(64, scale=0.1), g(64, nout, scale=0.1), g(nout, scale=0.1))
    f = sh.fused_seg_head
    before = f.launches
    _check(lambda: f(x, *wts, h, w), lambda: sh.fused_seg_head_plain(x, *wts, h, w),
           1e-4 if dtype == torch.float32 else 2 ** -6, f)
    assert f.launches == before + 2


def _low_bits(w):
    """w rounded to TF32 plus 0.45 of a TF32 ulp away from zero: a lo part
    near its largest, of the sign of w, which only the lo passes see."""
    hi, _ = split_tf32(w)
    ulp = (hi.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0 ** -10
    return hi + 0.45 * ulp * torch.sign(hi)


def ffn_low_bits_inputs(dev):
    """The float32 FFN tail's hard case: 600 rows (two batches of 300) of
    magnitude ~1e3, both weights with large lo parts; the smoke's scales."""
    _, g, _ = _rng_tensors(dev, 9)
    u = g(2, 300, 256, scale=1e3)
    args = [g(256, 1024, scale=0.05), g(1024, scale=0.1), g(1024, 256, scale=0.05),
            g(256, scale=0.1), 1 + g(256, scale=0.1), g(256, scale=0.1), 1 + g(256, scale=0.1),
            g(256, scale=0.1)]
    args[0], args[2] = _low_bits(args[0]), _low_bits(args[2])
    return u, args


def seg_head_low_bits_inputs(dev):
    """The float32 seg head's hard case: a 19 x 21 map of magnitude ~1e3,
    both conv kernels with large lo parts."""
    _, g, _ = _rng_tensors(dev, 10)
    x = g(1, 19 * 21, 256, scale=1e3)
    wts = [g(3, 3, 256, 128, scale=0.03), g(128, scale=0.1), g(3, 3, 128, 64, scale=0.04),
           g(64, scale=0.1), g(64, 4, scale=0.1), g(4, scale=0.1)]
    wts[0], wts[2] = _low_bits(wts[0]), _low_bits(wts[2])
    return x, wts, (19, 21)


def test_ffn_float32_low_bits(dev):
    """The float32 FFN tail where one TF32 pass is not enough: at these
    inputs a kernel without the lo passes misses 1e-4 (by 3.9x in the CPU
    emulation of `tests/test_torch_tf32x3.py`); the three-pass kernel
    meets it."""
    u, args = ffn_low_bits_inputs(dev)
    f = ffn.fused_ffn_ln
    _check(lambda: f(u, *args, eps=1e-6, compute_dtype=torch.float32),
           lambda: ffn.fused_ffn_ln_plain(u, *args, eps=1e-6, compute_dtype=torch.float32),
           1e-4, f)


def test_seg_head_float32_low_bits(dev):
    """The float32 seg head where one TF32 pass is not enough: at these
    inputs a kernel without the lo passes misses 1e-4 (by 6.5x in the CPU
    emulation of `tests/test_torch_tf32x3.py`); the three-pass kernels
    meet it."""
    x, wts, (h, w) = seg_head_low_bits_inputs(dev)
    f = sh.fused_seg_head
    _check(lambda: f(x, *wts, h, w), lambda: sh.fused_seg_head_plain(x, *wts, h, w), 1e-4, f)


@pytest.mark.parametrize("kernel", ["ffn_ln", "seg_head"])
def test_tf32_split_is_bitwise(dev, kernel):
    """The card's split of the weights (the kernel that each float32 call
    runs first) equals `ops/_tf32.py`'s bit for bit: hi, lo, the transposes
    and W2^T's K permutation; on values of every magnitude and sign."""
    rng, g, _ = _rng_tensors(dev, 11)
    mags = lambda *s: g(*s) * torch.from_numpy(
        10.0 ** rng.uniform(-30, 30, size=s)).float().to(dev)
    if kernel == "ffn_ln":
        ws = (mags(256, 1024), mags(1024, 256))
        got, want = ffn.tf32_split_weights(*ws), ffn.tf32_split_weights_plain(*ws)
    else:
        ws = (mags(3, 3, 256, 128), mags(3, 3, 128, 64))
        got, want = sh.tf32_split_weights(*ws), sh.tf32_split_weights_plain(*ws)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _small_models(dev, moved=False):
    """The float32 flagship at a 30x30 BEV grid on the CPU and the card,
    same weights (non-zero attention and offset weights); with `moved`,
    also a third copy on the card whose weights are moved by 1e-7 of each
    tensor's mean |value|."""
    xb = (-7.5, 7.5, 0.5)
    cfg = Config(grid=GridConfig(xbound=xb, ybound=xb), aug=AugConfig(final_dim=(32, 96)),
                 model=ModelConfig(family="vovnet_transformer"))
    cpu = build_model(cfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    card = build_model(cfg, device=dev, seed=3)
    card.load_state_dict(cpu.state_dict())
    if not moved:
        return cpu, card
    other = build_model(cfg, device=dev, seed=3)
    other.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        for p in other.parameters():
            p.add_(1e-7 * p.abs().mean() * torch.randn(p.shape, generator=gen).to(dev))
    return cpu, card, other


def _camera_args(b=2, n=6, h=32, w=96):
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(b, n, 3, h, w)).astype(np.float32)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)).copy()
    trans = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    intr = np.broadcast_to(np.array([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1.0]],
                                    np.float32), (b, n, 3, 3)).copy()
    post_r = np.broadcast_to(np.eye(3, dtype=np.float32) * (w / 1600.0), (b, n, 3, 3)).copy()
    post_r[..., 2, 2] = 1.0
    post_t = np.zeros((b, n, 3), np.float32)
    return [torch.from_numpy(a) for a in (imgs, rots, trans, intr, post_r, post_t)]


@pytest.mark.parametrize("flags", FLAGS)
def test_model_card_matches_cpu(request, flags):
    """The float32 flagship on the card (kernels) against the CPU (plain
    versions) at a 30x30 BEV grid, whose 900 tokens leave partial tiles in
    every kernel; the full-model tolerances (2e-3 BEV, 1e-3 action/desc).
    Once with TF32 turned off by the caller, once under torch's defaults with
    matrix products at "high": the forward pins full float32 itself, so there
    it also equals bit for bit the forward with TF32 turned off by the
    caller (the tolerances alone would pass an unpinned forward too)."""
    dev = _card(request, flags)
    cpu, card = _small_models(dev)
    args = _camera_args()
    b = 2
    with torch.inference_mode():
        want = cpu(*args)
        got = [t.cpu() for t in card(*[a.to(dev) for a in args])]
    assert got[0].shape == (b, 4, 30, 30)
    for g_, w_, atol in zip(got, want, (2e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(g_, w_, atol=atol, rtol=0)
    if flags != "tf32_off":
        old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            with torch.inference_mode():
                off = [t.cpu() for t in card(*[a.to(dev) for a in args])]
        finally:
            torch.backends.cudnn.allow_tf32 = old[0]
            torch.set_float32_matmul_precision(old[1])
        assert all(torch.equal(g_, o) for g_, o in zip(got, off))


def _relative_grad_diffs(got, want, top):
    """{leaf: norm of diff / norm} over the leaves of `want` whose gradient
    is not zero (above 1e-4 of `top`)."""
    want_g = {n: p.grad.cpu() for n, p in want.named_parameters()}
    rel = {}
    for n, p in got.named_parameters():
        a, b = p.grad.cpu(), want_g[n]
        if float(b.abs().max()) > 1e-4 * top:
            rel[n] = float((a - b).norm() / b.norm())
    return rel


@pytest.mark.parametrize("flags", FLAGS)
def test_train_step_card_matches_cpu(request, flags):
    """One float32 train step of the 30x30-grid flagship, dropout off, on the
    card (kernels 1-3 and the lift-splat backward) against the CPU (plain
    versions): loss to 1e-4 and grad_norm to 2e-3 relative. A leaf whose
    CPU gradient is below 1e-4 of the model's largest |grad| (a conv bias
    before a train-mode batch norm is zero in exact arithmetic) must stay
    below 1e-3 of it on the card; every other leaf must be non-zero on the
    card and within 0.25 in norm of the CPU's, median 0.06: at these small
    maps one ReLU flipped by round-off moves a layer's gradient visibly, as
    in tests/test_torch_train.py. The yardstick is printed beside it: the
    card against itself from weights moved by 1e-7. Once with TF32 turned
    off by the caller, once under torch's defaults with matrix products at
    "high": the train step pins full float32 itself, its backward too, and
    sums in fixed orders, so there it also gives the loss and every
    gradient of the step with TF32 turned off by the caller bit for bit
    (unpinned, the stem conv's gradient moved by 0.47 in norm at full
    size)."""
    dev = _card(request, flags)
    cpu, card, other = _small_models(dev, moved=True)
    off = build_model(card.cfg, device=dev, seed=3)
    off.load_state_dict(card.state_dict())
    args = _camera_args()
    rng = np.random.default_rng(8)
    batch = dict(zip(tsteps.MODEL_INPUTS, args),
                 binimg=torch.from_numpy(rng.integers(0, 4, size=(2, 30, 30))),
                 act=torch.from_numpy((rng.random((2, 4)) < 0.4).astype(np.float32)),
                 desc=torch.from_numpy((rng.random((2, 8)) < 0.4).astype(np.float32)))
    metrics = []
    for model, device in ((cpu, "cpu"), (card, dev), (other, dev)):
        opt, sched = ts.build_optimizer(model.cfg, tsteps.train_without_dropout(model))
        metrics.append(tsteps.train_step(model, opt, sched,
                                         {k: v.to(device) for k, v in batch.items()}, 0))
    want, got, _ = metrics
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=2e-3)
    cpu_g = {n: p.grad for n, p in cpu.named_parameters()}
    top = max(float(g.abs().max()) for g in cpu_g.values())
    for n, p in card.named_parameters():
        gmax = float(p.grad.abs().max())
        assert gmax <= 1e-3 * top if float(cpu_g[n].abs().max()) <= 1e-4 * top else gmax > 0, n
    rel = _relative_grad_diffs(card, cpu, top)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    control = _relative_grad_diffs(other, card, top)
    print(f"card vs CPU: worst {worst[0]}, median {float(np.median(list(rel.values()))):.3g}; "
          f"moved card vs card: worst {max(control.values()):.3g}, "
          f"median {float(np.median(list(control.values()))):.3g}")
    assert worst[0][1] <= 0.25 and float(np.median(list(rel.values()))) <= 0.06, worst
    if flags != "tf32_off":
        old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            opt, sched = ts.build_optimizer(off.cfg, tsteps.train_without_dropout(off))
            m_off = tsteps.train_step(off, opt, sched, {k: v.to(dev) for k, v in batch.items()}, 0)
        finally:
            torch.backends.cudnn.allow_tf32 = old[0]
            torch.set_float32_matmul_precision(old[1])
        assert torch.equal(got["loss"], m_off["loss"])
        off_g = dict(off.named_parameters())
        differ = [n for n, p in card.named_parameters() if not torch.equal(p.grad, off_g[n].grad)]
        assert not differ, differ[:5]


def test_train_step_repeats_bit_for_bit(dev_defaults):
    """The 30x30-grid flagship's float32 train step, dropout on (seeded by
    (seed, step)), run twice from one saved state on one batch under torch's
    default flags: the loss, every gradient, every parameter and buffer
    after the step and Adam's moments are the same bits (the deformable
    backward sums dv in a fixed order, the resize is two products, cuDNN is
    held to deterministic algorithms by the step)."""
    import copy

    dev = dev_defaults
    _, card = _small_models(dev)
    opt, sched = ts.build_optimizer(card.cfg, card.train())
    args = _camera_args()
    rng = np.random.default_rng(9)
    batch = dict(zip(tsteps.MODEL_INPUTS, (a.to(dev) for a in args)),
                 binimg=torch.from_numpy(rng.integers(0, 4, size=(2, 30, 30))).to(dev),
                 act=torch.from_numpy((rng.random((2, 4)) < 0.4).astype(np.float32)).to(dev),
                 desc=torch.from_numpy((rng.random((2, 8)) < 0.4).astype(np.float32)).to(dev))
    tsteps.train_step(card, opt, sched, batch, 0)  # Adam's moments exist from here
    saved = ({k: v.clone() for k, v in card.state_dict().items()},
             copy.deepcopy(opt.state_dict()), copy.deepcopy(sched.state_dict()))
    runs = []
    for _ in range(2):
        card.load_state_dict(saved[0])
        opt.load_state_dict(copy.deepcopy(saved[1]))
        sched.load_state_dict(saved[2])
        m = tsteps.train_step(card, opt, sched, batch, 1)
        leaves = {"loss": m["loss"].clone()}
        leaves.update((f"grad {n}", p.grad.clone()) for n, p in card.named_parameters())
        leaves.update((f"weight {n}", t.clone()) for n, t in card.state_dict().items())
        leaves.update((f"{k} {i}", st[k].clone()) for i, st in enumerate(opt.state.values())
                      for k in ("exp_avg", "exp_avg_sq"))
        runs.append(leaves)
    differ = [n for n, t in runs[0].items() if not torch.equal(t, runs[1][n])]
    assert not differ, differ[:5]
    assert any(n.startswith("exp_avg ") for n in runs[0])


def test_train_steps_use_no_op_torch_knows_to_be_nondeterministic(dev):
    """`scripts/port_determinism.py` in its own process (with
    `CUBLAS_WORKSPACE_CONFIG` and `torch.use_deterministic_algorithms(True,
    warn_only=True)` in a child of its own): one flagship bf16 step and one
    train-v2 f32 step at B=8 at full width, and no operation torch flags."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, str(root / "scripts" / "port_determinism.py")],
                         capture_output=True, text=True, timeout=900, cwd=root)
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-4000:])
    result = json.loads(run.stdout.strip().splitlines()[-2])
    assert result["flagged"] == 0 and set(result["paths"]) == {"flagship bf16",
                                                               "train-v2 flagship f32"}


def _c64_operands(dev, dtype, b, seed, live=True):
    """Stack A's lift-splat width, C=64 (rows of 128 bytes in bfloat16, 256 in
    float32: lane groups of 8 and 16 slices), B=b, 1001 points (off every
    lane group), 30% depth-0 points with seg 0 as `lift_splat` prepares
    them, and voxel 49 holding exactly one point per batch element; with
    `live` False, every depth is 0."""
    rng, g, u = _rng_tensors(dev, seed)
    r, p, c, nv = 17, 1001, 64, 50
    depth = u(b, p) * (u(b, p) > 0.3) if live else torch.zeros(b, p, device=dev)
    seg = torch.from_numpy(rng.integers(0, nv - 1, (b, p)).astype(np.int32)).to(dev)
    if live:
        depth[:, 0] = 0.5
        seg[:, 0] = nv - 1
    seg = torch.where(depth != 0, seg, 0)
    fidx = torch.from_numpy(rng.integers(0, r, (b, p)).astype(np.int32)).to(dev)
    return g(b, r, c).to(dtype), depth, seg, fidx, nv, g(b, nv, c).to(dtype)


def _check_backward(dfeat, ddepth, want_feat, want_depth, dtype):
    tol_feat = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, a, b, tol in (("dfeat", dfeat, want_feat, tol_feat),
                            ("ddepth", ddepth, want_depth, 1e-5)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3])
def test_lift_splat_c64_ragged(dev, dtype, b):
    """Forward and backward at C=64 against their plain versions (phase 2's
    limits), repeated bit for bit; the voxel of one point gets that point's
    weighted row."""
    feat, depth, seg, fidx, nv, cot = _c64_operands(dev, dtype, b, seed=40 + b)
    f = ls.fused_lift_splat
    _check(lambda: f(feat, depth, seg, fidx, nv),
           lambda: ls.fused_lift_splat_plain(feat, depth, seg, fidx, nv),
           1e-5 if dtype == torch.float32 else 2 ** -7, f)
    out = f(feat, depth, seg, fidx, nv)
    assert torch.equal(out, f(feat, depth, seg, fidx, nv))
    one = (feat[torch.arange(b), fidx[:, 0].long()].float() * 0.5).to(dtype)
    assert torch.equal(out[:, nv - 1], one)
    before = ls.fused_lift_splat_backward.launches
    dfeat, ddepth = ls.fused_lift_splat_backward(feat, depth, seg, fidx, cot)
    torch.cuda.synchronize()
    assert ls.fused_lift_splat_backward.launches == before + 1
    _check_backward(dfeat, ddepth, *ls.fused_lift_splat_backward_plain(feat, depth, seg, fidx, cot),
                    dtype)
    again = ls.fused_lift_splat_backward(feat, depth, seg, fidx, cot)
    assert torch.equal(dfeat, again[0]) and torch.equal(ddepth, again[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_lift_splat_c64_no_live_points(dev, dtype):
    """No point with a non-zero depth: the forward writes zeros everywhere,
    the backward a zero dfeat and every point's ddepth (the dot of its g and
    feature rows) as its plain version does."""
    feat, depth, seg, fidx, nv, cot = _c64_operands(dev, dtype, 2, seed=44, live=False)
    out = ls.fused_lift_splat(feat, depth, seg, fidx, nv)
    torch.cuda.synchronize()
    assert out.shape == (2, nv, 64) and not bool(out.any())
    dfeat, ddepth = ls.fused_lift_splat_backward(feat, depth, seg, fidx, cot)
    assert not bool(dfeat.any()) and bool(ddepth.any())
    _check_backward(dfeat, ddepth, *ls.fused_lift_splat_backward_plain(feat, depth, seg, fidx, cot),
                    dtype)


def test_lift_splat_widths_alternate(dev):
    """Stack A (C=64) and the flagship (C=128) share the frustum's shape (6
    cameras, 41 depth bins, 8x22), so `lift_splat` serves both from one
    cached fidx and CSR: forward and backward at 64, 128, 64, 128 in one
    process, each against the CPU, and the cache holds one entry for the
    shape."""
    rng = np.random.default_rng(46)
    b, n, d, fh, fw, nx = 2, 6, 41, 8, 22, (200, 200, 1)
    idx = np.stack([rng.integers(0, 200, (b, n, d, fh, fw)), rng.integers(0, 200, (b, n, d, fh, fw)),
                    np.zeros((b, n, d, fh, fw), np.int64)], -1).astype(np.int32)
    valid = rng.random((b, n, d, fh, fw)) < 0.6
    logits = torch.from_numpy(rng.normal(size=(b, n, d, fh, fw)).astype(np.float32))
    ls._feature_rows_on.cache_clear()
    for c in (64, 128, 64, 128):
        feat = torch.from_numpy(rng.normal(size=(b, n, c, fh, fw)).astype(np.float32))
        cot = torch.from_numpy(rng.normal(size=(b, c, 200, 200)).astype(np.float32))
        results = []
        for device in ("cpu", dev):
            f = feat.clone().to(device).requires_grad_()
            lg = logits.clone().to(device).requires_grad_()
            out = ls.lift_splat(f, torch.softmax(lg, 2), torch.from_numpy(idx).to(device),
                                torch.from_numpy(valid).to(device), nx)
            (out * cot.to(device)).sum().backward()
            results.append([t.detach().cpu() for t in (out, f.grad, lg.grad)])
        for name, a, w in zip(("bev", "dfeat", "dlogits"), results[1], results[0]):
            err = float((a - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()), (c, name, err)
    assert ls._feature_rows_on.cache_info().currsize == 2  # one shape, on the CPU and the card


def _stack_a_models(dev, family="bev_txt"):
    """Stack A at b0 with C=64 on the CPU and the card, same weights: random
    batch-norm affines, running statistics set to the batch statistics of
    one train forward at `_stack_a_args` (so activations stay of order 1, as
    in a trained model)."""
    cfg = Config(model=ModelConfig(family=family, effnet_variant="b0"))
    cpu = build_model(cfg, device="cpu", seed=6)
    gen = torch.Generator().manual_seed(7)
    bns = [m for m in cpu.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
            m.momentum = 1.0
        tsteps.train_without_dropout(cpu)(*_stack_a_args())
    for m in bns:
        m.momentum = 0.1 if m.eps == 1e-5 else 0.01
    cpu.eval()
    card = build_model(cfg, device=dev, seed=6)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _stack_a_args(b=1):
    return _camera_args(b, h=128, w=352)


@pytest.mark.parametrize("flags", FLAGS)
def test_bev_txt_card_matches_cpu(request, flags):
    """BevTxt (b0, C=64, 6 cameras at 128x352, the 200x200 grid) at B=1 on
    the card (lift-splat) against the CPU (plain versions): 2e-3 on the BEV,
    1e-3 on act/desc; one lift-splat launch; cuDNN on again after the BEV
    decoder's 200x200 conv, which runs without it in float32."""
    dev = _card(request, flags)
    cpu, card = _stack_a_models(dev)
    args = _stack_a_args()
    before = ls.fused_lift_splat.launches
    with torch.inference_mode():
        want = cpu(*args)
        got = [t.cpu() for t in card(*[a.to(dev) for a in args])]
    assert ls.fused_lift_splat.launches == before + 1 and torch.backends.cudnn.enabled
    assert got[0].shape == (1, 4, 200, 200) and float(want[0].abs().max()) > 0.1
    for g_, w_, atol in zip(got, want, (2e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(g_, w_, atol=atol, rtol=0)


@pytest.mark.parametrize("family", ["vovnet_transformer", "vovnet_pretrain"])
def test_train_seg_head_first_conv_runs_off_cudnn(dev, family):
    """In a float32 train step on the card the BEV encoder's seg head runs
    its first conv (3x3 256 -> 128) with cuDNN off (`nn/fusion.py`: cuDNN's
    FFT tiling there took 265-454 ms at B=12), every other conv of the forward
    with cuDNN, and cuDNN is on again after the step, its backward
    included; in eval the seg head is kernel 5 and no conv runs off
    cuDNN."""
    import torch.nn.functional as F

    xb = (-7.5, 7.5, 0.5)
    cfg = Config(grid=GridConfig(xbound=xb, ybound=xb), aug=AugConfig(final_dim=(32, 96)),
                 model=ModelConfig(family=family, lss_version="v1"))
    model = build_model(cfg, device=dev, seed=3)
    args = [a.to(dev) for a in _camera_args()]
    rng = np.random.default_rng(9)
    batch = dict(zip(tsteps.MODEL_INPUTS, args),
                 binimg=torch.from_numpy(rng.integers(0, 4, size=(2, 30, 30))).to(dev),
                 act=torch.from_numpy((rng.random((2, 4)) < 0.4).astype(np.float32)).to(dev),
                 desc=torch.from_numpy((rng.random((2, 8)) < 0.4).astype(np.float32)).to(dev))
    calls, orig = {"train": [], "eval": []}, F.conv2d
    where = ["train"]

    def recording(x, w, *a, **k):
        calls[where[0]].append((tuple(w.shape), torch.backends.cudnn.enabled))
        return orig(x, w, *a, **k)

    opt, sched = ts.build_optimizer(cfg, model.train())
    F.conv2d = recording
    try:
        metrics = tsteps.train_step(model, opt, sched, batch, 0)
        where[0] = "eval"
        with torch.inference_mode():
            model.eval()(*args)
    finally:
        F.conv2d = orig
    assert torch.backends.cudnn.enabled and torch.isfinite(metrics["loss"])
    assert [s for s, on in calls["train"] if not on] == [(128, 256, 3, 3)], calls["train"]
    assert all(on for _, on in calls["eval"]) and calls["eval"]
    assert (128, 256, 3, 3) not in [s for s, _ in calls["eval"]]


def test_bev_losses_repeat_bit_for_bit(dev):
    """The BEV cross entropies at a train step's size (B=12, 4 classes,
    200x200, a fifth of the labels at 255 for the pretrain's) give the same
    bits on every call, their gradients too (the port sums them itself, in
    a fixed order, where `F.cross_entropy`'s own reduction promises none);
    and they agree with it to 1e-6 relative."""
    from lss2_multimodal_nu_tpu_torch.train import losses

    gen = torch.Generator(device=dev).manual_seed(10)
    logits = (3 * torch.randn(12, 4, 200, 200, device=dev, generator=gen)).requires_grad_()
    labels = torch.randint(0, 4, (12, 200, 200), device=dev, generator=gen)
    ignored = torch.where(torch.rand(labels.shape, device=dev, generator=gen) < 0.2, 255, labels)
    weight = torch.tensor(losses.BEV_CLASS_WEIGHTS, device=dev)
    for fn, lab, want in (
            (lambda x, y: losses.weighted_cross_entropy(x, y, losses.BEV_CLASS_WEIGHTS), labels,
             torch.nn.functional.cross_entropy(logits, labels, weight=weight)),
            (losses.cross_entropy_ignore, ignored,
             torch.nn.functional.cross_entropy(logits, ignored, ignore_index=255))):
        runs = [fn(logits, lab) for _ in range(5)]
        grads = [torch.autograd.grad(r, logits)[0] for r in runs]
        assert all(torch.equal(r, runs[0]) for r in runs)
        assert all(torch.equal(g, grads[0]) for g in grads)
        torch.testing.assert_close(runs[0], want.detach(), rtol=1e-6, atol=0)


# ---- the data slice: kernel 6 (JPEG IDCT), kernel 7 (augmentation), the host
# entropy decoder. JPEGs are written by the port's own encoder (this file
# runs where PIL is not installed); everything is held bit for bit.

def _random_coefficients(rng, h, w, ncomp, sampling):
    """A `Coefficients` of random quantised values (small, as real blocks
    have them) with the standard tables at a random quality."""
    from lss2_multimodal_nu_tpu_torch.data import jpeg

    qy, qc = jpeg.quality_tables(int(rng.integers(50, 101)))
    hs, vs = sampling
    mx, my = -(-w // (8 * hs)), -(-h // (8 * vs))
    n = my * vs * mx * hs + (ncomp - 1) * mx * my
    coefs = np.clip(np.round(rng.laplace(0, 3, (n, 64))), -200, 200).astype(np.int16)
    coefs[:, 0] = rng.integers(-60, 60, n)
    quant = np.stack([qy, qc, qc][:ncomp]).astype(np.int32)
    return jpeg.Coefficients(h, w, sampling, quant, coefs)


@pytest.mark.parametrize("h, w, n", [(1, 1, 4), (3, 5, 4), (4, 4, 4), (4, 3, 4), (16, 16, 4),
                                     (17, 23, 4), (33, 47, 4), (48, 32, 4), (90, 160, 4),
                                     (225, 400, 4), (900, 1600, 4), (900, 1600, 56)])
def test_jpeg_idct_matches_plain(dev, h, w, n):
    """Kernel 6 against its plain version on one batch mixing 4:2:0, 4:4:4
    and one-component images, at odd sizes (partial MCUs, widths and
    heights of 1-3 MCUs, chroma 1-2 wide where libjpeg replicates instead
    of the fancy upsampling); at 900x1600 with 4 images in bands of a few
    MCU rows, with 56 in one band of the whole height."""
    from lss2_multimodal_nu_tpu_torch.ops import jpeg_idct

    rng = np.random.default_rng(h * 1000 + w + n)
    kinds = [(3, (2, 2)), (3, (1, 1)), (1, (1, 1)), (3, (2, 2))]
    images = [_random_coefficients(rng, h, w, *kinds[i % 4]) for i in range(n)]
    coefs, quant, meta, hh, ww = jpeg_idct.pack(images)
    on_card = [torch.from_numpy(a).to(dev) for a in (coefs, quant, meta)]
    want = jpeg_idct.decode_plain(*on_card, hh, ww)
    before = jpeg_idct.decode.launches
    got = jpeg_idct.decode(*on_card, hh, ww)
    torch.cuda.synchronize()
    assert jpeg_idct.decode.launches == before + 1
    assert torch.equal(got, want)


def test_jpeg_idct_refuses_mixed_sizes_and_dtypes(dev):
    from lss2_multimodal_nu_tpu_torch.ops import jpeg_idct

    rng = np.random.default_rng(1)
    with pytest.raises(ValueError):
        jpeg_idct.pack([_random_coefficients(rng, 16, 16, 3, (2, 2)),
                        _random_coefficients(rng, 16, 24, 3, (2, 2))])
    coefs, quant, meta, h, w = jpeg_idct.pack([_random_coefficients(rng, 16, 16, 3, (2, 2))])
    with pytest.raises(ValueError):
        jpeg_idct.decode(torch.from_numpy(coefs).to(dev).int(), torch.from_numpy(quant).to(dev),
                         torch.from_numpy(meta).to(dev), h, w)


@pytest.mark.parametrize("h, w, final_dim, rot_lim", [
    (225, 400, (32, 88), None), (90, 160, (32, 88), None), (900, 1600, (128, 352), None),
    (37, 61, (13, 29), None), (900, 1600, (13, 29), None), (37, 61, (64, 128), None),
    (90, 160, (32, 88), (-40.0, 40.0)), (200, 700, (40, 600), None)])
def test_img_aug_matches_plain(dev, h, w, final_dim, rot_lim):
    """Kernel 7 against its plain version over 24 draws each: train draws
    with flips and rotations of both signs, crops past the resized image,
    and eval draws (no rotation); eval windows of about 220 taps at
    900x1600 -> 13x29 (the horizontal pass stages its span in turns),
    upsampling, rotations to 40 degrees, a crop 600 wide."""
    from lss2_multimodal_nu_tpu_torch.config import AugConfig as TAug
    from lss2_multimodal_nu_tpu_torch.core.augment import sample_augmentation
    from lss2_multimodal_nu_tpu_torch.ops import img_aug

    rng = np.random.default_rng(h + w)
    conf = TAug(H=h, W=w, final_dim=final_dim, rand_flip=True,
                **({} if rot_lim is None else {"rot_lim": rot_lim}))
    draws = [sample_augmentation(conf, i % 4 != 0, rng) for i in range(24)]
    assert any(p.flip for p in draws) and any(p.rotate < 0 for p in draws)
    assert any(p.rotate > 0 for p in draws) and any(p.rotate == 0 for p in draws)
    images = torch.from_numpy(rng.integers(0, 256, (24, h, w, 3), dtype=np.uint8))
    params, htab, vtab, rows = img_aug.plan(draws, h, w, final_dim)
    tabs = [torch.from_numpy(a) for a in (params, htab, vtab)]
    want = img_aug.augment(images, *tabs, final_dim, rows)
    before = img_aug.augment.launches
    got = img_aug.augment(images.to(dev), *[t.to(dev) for t in tabs], final_dim, rows)
    torch.cuda.synchronize()
    assert img_aug.augment.launches == before + (2 if rows else 1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("h, w, quality", [(1, 1, 95), (17, 23, 50), (90, 160, 95),
                                           (225, 400, 75), (900, 1600, 95)])
def test_entropy_decoder_matches_python(dev, h, w, quality):
    """The C++ entropy decoder (`csrc/jpeg_entropy.cu`, built with the
    kernels) against the Python one on the port encoder's files."""
    from lss2_multimodal_nu_tpu_torch.data import jpeg

    img = np.clip(np.random.default_rng(h).normal(120, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    data = jpeg.encode(img, quality)
    got = jpeg.decode_coefficients(data, library=True)
    want = jpeg.decode_coefficients(data, library=False)
    np.testing.assert_array_equal(got.coefs, want.coefs)
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_coefficients(data[:len(data) // 2] + bytes(8) + data[-2:], library=True)


def test_loader_on_the_card_matches_the_cpu(dev, tmp_path):
    """The port's fixture at 90x160 through the loader on the card (C++
    entropy decoder, kernels 6 and 7, pinned copies one batch ahead on a
    side stream) and on the CPU (plain versions): the same batches bit for
    bit, train (flips, two epochs) and val; the device stage makes no host
    sync."""
    from lss2_multimodal_nu_tpu_torch.config import AugConfig as TAug, GridConfig as TGrid
    from lss2_multimodal_nu_tpu_torch.data import dataset, loader, nuscenes_index, synthetic

    root = str(tmp_path)
    synthetic.generate(root, seed=4)
    aug = TAug(H=90, W=160, final_dim=(32, 88), rand_flip=True)
    for is_train in (True, False):
        runs = {}
        for device in ("cpu", dev):
            ds_ = dataset.NuA2DDataset(nuscenes_index.NuScenesIndex("v1.0-mini", root), is_train,
                                       aug, TGrid(), root, rng=5, device=device)
            dl = loader.DataLoader(ds_, 2, shuffle=is_train, num_workers=2)
            runs[str(device)] = [b for _ in range(2 if is_train else 1) for b in dl]
        torch.cuda.synchronize()
        cpu, card = runs["cpu"], runs[str(dev)]
        assert len(cpu) == len(card) > 0
        for a, b in zip(cpu, card):
            assert set(a) == set(b)
            for k in a:
                assert b[k].device.type == "cuda" and torch.equal(a[k], b[k].cpu()), k
    hb = next(iter(loader.DataLoader(ds_, 2, shuffle=False, num_workers=1).host_batches()))
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = dataset.device_stage(hb, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert batch["imgs"].shape == (2, 6, 3, 32, 88)


# ---- kernel 8 (`ops/conv.py`): the VoVNet-39 trunk's float32 convs
# (Cin, H, W, Cout, k, stride) of every distinct conv that runs on kernel 8
# at 128 x 352, the stem's last two through stage 4
TRUNK_CONVS = [
    (64, 64, 176, 64, 3, 1), (64, 64, 176, 128, 3, 2), (128, 32, 88, 128, 3, 1),
    (768, 32, 88, 256, 1, 1), (256, 16, 44, 160, 3, 1), (160, 16, 44, 160, 3, 1),
    (1056, 16, 44, 512, 1, 1), (512, 8, 22, 192, 3, 1), (192, 8, 22, 192, 3, 1),
    (1472, 8, 22, 768, 1, 1), (768, 8, 22, 192, 3, 1), (1728, 8, 22, 768, 1, 1),
    (768, 4, 11, 224, 3, 1), (224, 4, 11, 224, 3, 1), (1888, 4, 11, 1024, 1, 1),
    (1024, 4, 11, 224, 3, 1), (2144, 4, 11, 1024, 1, 1),
]


def _conv_inputs(dev, b, cin, h, w, cout, k, seed=12):
    """ReLU'd normal activations (as the trunk's are), He-normal weights, a
    bias; from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(np.maximum(rng.normal(size=(b, cin, h, w)), 0)),
            t(rng.normal(size=(cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k))),
            t(rng.normal(0, 0.1, cout)))


@pytest.mark.parametrize("shape", TRUNK_CONVS, ids=lambda s: "x".join(map(str, s)))
def test_conv_kernel_trunk_shapes(dev, shape):
    """Kernel 8 at the trunk's shapes, B = 8 x 6 cameras, in its eval form
    (bias and ReLU in the epilogue): within 1e-4 of its plain version's
    largest output (cuDNN float32, TF32 off), the same bits on a second
    call, and no further from float64 than twice cuDNN float32's distance
    (`scripts/port_conv.py` holds it to the same limit), at the shapes where
    cuDNN runs FFT tiling and at the 16 x 44 3x3s, where it runs a float32
    implicit GEMM on the CUDA cores."""
    from lss2_multimodal_nu_tpu_torch.ops import conv

    cin, h, w, cout, k, s = shape
    x, wt, bias = _conv_inputs(dev, 48, cin, h, w, cout, k)
    with torch.inference_mode():
        f = conv.conv2d_tf32x3
        _check(lambda: f(x, wt, bias, s, k // 2, relu=True),
               lambda: conv.conv2d_tf32x3_plain(x, wt, bias, s, k // 2, relu=True), 1e-4, f)
        got = f(x, wt, bias, s, k // 2, relu=True)
        assert torch.equal(got, f(x, wt, bias, s, k // 2, relu=True))
        want = torch.relu(torch.nn.functional.conv2d(x.double(), wt.double(), bias.double(), s,
                                                     k // 2))
        err = float((got.double() - want).abs().max())
        err_cudnn = float((conv.conv2d_tf32x3_plain(x, wt, bias, s, k // 2, relu=True).double()
                           - want).abs().max())
    assert err <= 2 * err_cudnn, (err, err_cudnn)


# (B, Cin, H, W, Cout, k, stride, mt, n, tw): each instantiation at ragged
# shapes, as `tests/test_torch_conv.py` replays them on the CPU
CONV_TILES = [
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
@pytest.mark.parametrize("case", CONV_TILES, ids=lambda c: "x".join(map(str, c)))
def test_conv_kernel_ragged(dev, monkeypatch, case, relu):
    """Every instantiation of kernel 8, each forced by its plan, at ragged
    shapes: channels off 32, partial N tiles, images stacked under one tile,
    tiles past the last column; against the plain version within 1e-4, the
    train form (no bias, no ReLU) too."""
    from lss2_multimodal_nu_tpu_torch.ops import conv

    b, cin, h, w, cout, k, s, mt, n, tw = case
    p = conv.tile_plan(b, cin, h, w, cout, k, s, mt, n, tw)
    monkeypatch.setattr(conv, "plan", lambda *a: p)
    x, wt, bias = _conv_inputs(dev, b, cin, h, w, cout, k, seed=13)
    bias = bias if relu else None
    f = conv.conv2d_tf32x3
    with torch.inference_mode():
        _check(lambda: f(x, wt, bias, s, k // 2, relu=relu),
               lambda: conv.conv2d_tf32x3_plain(x, wt, bias, s, k // 2, relu=relu), 1e-4, f)


def test_conv_split_is_bitwise(dev):
    """The card's split of a conv weight equals `tf32_split_weight_plain`
    bit for bit, on values of every magnitude and sign."""
    from lss2_multimodal_nu_tpu_torch.ops import conv

    rng, g, _ = _rng_tensors(dev, 14)
    w = g(72, 40, 3, 3) * torch.from_numpy(10.0 ** rng.uniform(-30, 30, (72, 40, 3, 3))).float().to(dev)
    got, want = conv.tf32_split_weight(w), conv.tf32_split_weight_plain(w)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_conv_kernel_refuses_grad(dev):
    """Kernel 8 has no backward: a CUDA call that autograd would have to
    differentiate raises (`ConvBnAct` sends such convs to cuDNN)."""
    from lss2_multimodal_nu_tpu_torch.ops import conv

    x, wt, bias = _conv_inputs(dev, 2, 64, 8, 12, 64, 3, seed=15)
    with pytest.raises(RuntimeError, match="eval-only"):
        conv.conv2d_tf32x3(x, wt.requires_grad_(), bias, 1, 1)
    with torch.no_grad():
        assert conv.conv2d_tf32x3(x, wt, bias, 1, 1).shape == (2, 64, 8, 12)


def test_flagship_eval_forward_runs_trunk_convs_on_kernel8(dev):
    """A float32 flagship eval forward at LSS v1 (c3 alone, as the
    benchmark's) runs 26 convs on kernel 8: every ConvBnAct of VoVNet-39's
    stem and stages 1-3 but the stem's first (Cin 3, K 27, on F.conv2d by
    the shape rule); a bfloat16 forward none."""
    import dataclasses

    from lss2_multimodal_nu_tpu_torch.ops import conv

    cfg = _small_models(dev)[1].cfg
    build = lambda **m: build_model(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, lss_version="v1", **m)), device=dev, seed=3)
    args = [a.to(dev) for a in _camera_args()]
    for model, want in ((build(), 26), (build(compute_dtype="bfloat16"), 0)):
        before = conv.conv2d_tf32x3.launches
        with torch.inference_mode():
            model(*args)
        torch.cuda.synchronize()
        assert conv.conv2d_tf32x3.launches - before == want
