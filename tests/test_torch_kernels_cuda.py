"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes that the flagship's (all multiples of the kernels' tiles)
never reach: partial query, row and pixel tiles, channel counts that are
no multiple of a warp, non-square maps, and the deformable kernels at the
edges of their query tiles and lane groups (and their refusal of a dh that
is no multiple of 8). Plus the whole model in float32 on
the card against the CPU at a 30x30 BEV grid, in eval and for one train
step with its gradients.

Marked `cuda`; each test skips without a card. On the card, without JAX
(this file imports none, and the suite's conftest imports JAX):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances are those of `chip_smoke.py`, relative to the plain output's
largest magnitude: float32 1e-5 for the gathers and the scatter (sum
order), 1e-4 for the matrix-product kernels; bfloat16 one ulp (2^-7), or
two (2^-6) where the kernel rounds an intermediate to bf16."""
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu_torch.config import AugConfig, Config, GridConfig, ModelConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
from lss2_multimodal_nu_tpu_torch.ops import ffn
from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh
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
    (float32 atomics in a varying order) or 2^-6 (bfloat16, rounded once);
    dlx, dly, dattn are float32 in both dtypes, 1e-4, for rc_01 - rc_00
    cancels."""
    _, g, u = _rng_tensors(dev, 6)
    bh, h, w, npts = 3, 7, 9, 5
    v = g(bh, h * w, dh).to(dtype)
    cot = g(bh, h * w, dh).to(dtype)
    lx, ly = (torch.clamp(u(bh, npts, h * w) * 1.2 - 0.1, 0, 1) for _ in range(2))
    attn = torch.softmax(g(bh, npts, h * w), dim=1)
    f = ds.deformable_sample_combine_xy_backward
    before = f.launches
    got = f(v, lx, ly, attn, cot, h, w)
    torch.cuda.synchronize()
    assert f.launches == before + 1
    want = ds.deformable_sample_combine_xy_backward_plain(v, lx, ly, attn, cot, h, w)
    tols = (5e-5 if dtype == torch.float32 else 2 ** -6, 1e-4, 1e-4, 1e-4)
    for name, a, b, tol in zip(("dv", "dlx", "dly", "dattn"), got, want, tols):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)


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
    outputs at the tolerances of `test_deformable_backward_ragged`."""
    (h, w), args, cot = _deform_edge_inputs(dev, dtype, edge, npts, dh, 12)
    f = ds.deformable_sample_combine_xy_backward
    before = f.launches
    got = f(*args, cot, h, w)
    torch.cuda.synchronize()
    assert f.launches == before + 1
    want = ds.deformable_sample_combine_xy_backward_plain(*args, cot, h, w)
    tols = (5e-5 if dtype == torch.float32 else 2 ** -6, 1e-4, 1e-4, 1e-4)
    for name, a, b, tol in zip(("dv", "dlx", "dly", "dattn"), got, want, tols):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("npts", [5, 8])
def test_deformable_rows_wider_than_a_warp(dev, dtype, npts):
    """dh=264: 33 slices of 16 bytes in bf16 and 66 in float32, more than
    a warp's 32 lanes, so each lane serves a query in 2 or 3 passes. Both
    kernels against their plain versions at the tolerances above."""
    (h, w), args, cot = _deform_edge_inputs(dev, dtype, "tile_plus_1", npts, 264, 14)
    f = ds.deformable_sample_combine_xy
    bf = dtype == torch.bfloat16
    _check(lambda: f(*args, h, w), lambda: ds.deformable_sample_combine_xy_plain(*args, h, w),
           2 ** -7 if bf else 1e-5, f)
    got = ds.deformable_sample_combine_xy_backward(*args, cot, h, w)
    want = ds.deformable_sample_combine_xy_backward_plain(*args, cot, h, w)
    for name, a, b, tol in zip(("dv", "dlx", "dly", "dattn"), got, want,
                               (2 ** -6 if bf else 5e-5, 1e-4, 1e-4, 1e-4)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)


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
    """C=40 (no multiple of 32), 1001 points (a partial run of 64)."""
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n", [(2, 77), (1, 1), (1, 127), (1, 129), (1, 132 * 128 + 77)])
def test_ffn_ragged(dev, dtype, b, n):
    """Row counts off the 64-row tiles of the float32 kernel and the 128-row
    blocks (64-row warpgroup halves) of the bfloat16 one: 154 rows in two
    batches, 1, 127, 129, and more blocks than the card has SMs."""
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
@pytest.mark.parametrize("b,h,w", [(2, 9, 13), (2, 1, 1), (1, 17, 203), (1, 200, 200)])
def test_seg_head_ragged(dev, dtype, nout, b, h, w):
    """Maps off the pixel tiles (64 pixels in float32, 16 x 16 in bfloat16):
    9 x 13 (every row near a border), a single pixel (every tap but the
    centre reads the padding), 17 x 203 (partial tiles both ways) and the
    flagship's 200 x 200 at B=1; 3 and 4 output classes; both launches."""
    _, g, _ = _rng_tensors(dev, 4)
    x = g(b, h * w, 256, scale=0.5).to(dtype)
    wts = (g(3, 3, 256, 128, scale=0.03), g(128, scale=0.1), g(3, 3, 128, 64, scale=0.04),
           g(64, scale=0.1), g(64, nout, scale=0.1), g(nout, scale=0.1))
    f = sh.fused_seg_head
    before = f.launches
    _check(lambda: f(x, *wts, h, w), lambda: sh.fused_seg_head_plain(x, *wts, h, w),
           1e-4 if dtype == torch.float32 else 2 ** -6, f)
    assert f.launches == before + 2


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


def _camera_args(b=2, n=6):
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(b, n, 3, 32, 96)).astype(np.float32)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)).copy()
    trans = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    intr = np.broadcast_to(np.array([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1.0]],
                                    np.float32), (b, n, 3, 3)).copy()
    post_r = np.broadcast_to(np.eye(3, dtype=np.float32) * (96 / 1600.0), (b, n, 3, 3)).copy()
    post_r[..., 2, 2] = 1.0
    post_t = np.zeros((b, n, 3), np.float32)
    return [torch.from_numpy(a) for a in (imgs, rots, trans, intr, post_r, post_t)]


def test_model_card_matches_cpu(dev):
    """The float32 flagship on the card (kernels) against the CPU (plain
    versions) at a 30x30 BEV grid, whose 900 tokens leave partial tiles in
    every kernel; the full-model tolerances (2e-3 BEV, 1e-3 action/desc)."""
    cpu, card = _small_models(dev)
    args = _camera_args()
    b = 2
    with torch.inference_mode():
        want = cpu(*args)
        got = [t.cpu() for t in card(*[a.to(dev) for a in args])]
    assert got[0].shape == (b, 4, 30, 30)
    for g_, w_, atol in zip(got, want, (2e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(g_, w_, atol=atol, rtol=0)


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


def test_train_step_card_matches_cpu(dev):
    """One float32 train step of the 30x30-grid flagship, dropout off, on the
    card (kernels 1-3 and the lift-splat backward) against the CPU (plain
    versions): loss to 1e-4 and grad_norm to 2e-3 relative. A leaf whose
    CPU gradient is below 1e-4 of the model's largest |grad| (a conv bias
    before a train-mode batch norm is zero in exact arithmetic) must stay
    below 1e-3 of it on the card; every other leaf must be non-zero on the
    card and within 0.25 in norm of the CPU's, median 0.06: at these small
    maps one ReLU flipped by round-off moves a layer's gradient visibly, as
    in tests/test_torch_train.py. The yardstick is printed beside it: the
    card against itself from weights moved by 1e-7."""
    cpu, card, other = _small_models(dev, moved=True)
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
