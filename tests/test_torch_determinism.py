"""A train step that repeats bit for bit: the pieces of it that the CPU can
check.

- The deformable backward's dv in the kernel's fixed order
  (`deformable_dv_ordered_plain`: the points sorted by cell, each dv row
  summing its four cells, a cell of more than `chunk` points in pieces)
  against the explicit plain backward and against the JAX package's
  backward, run in the Pallas interpreter as `tests/test_torch_kernels.py`
  runs it, at ragged maps and query counts, with points outside the map, on
  its edges, at x0 = -1 and all in one cell; float32, 1e-5 of the largest
  |dv|.
- The CSR of the points by cell against numpy's stable argsort.
- `resize_bilinear`, now two products with the JAX package's interpolation
  matrices, forward and gradient against the JAX package's resize and
  `jax.vjp`, both `align_corners`, up and down, at the three call sites'
  kinds of shape; float32, 1e-6.
- The cuDNN pin: `torch.backends.cudnn.deterministic` set inside
  `train_step`, its backward too, and the caller's value restored after,
  also after an exception.

Small shapes, one torch thread; the JAX results are made once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu.ops import deformable_pallas as dp
from lss2_multimodal_nu_tpu.ops.sampling import resize_bilinear as j_resize_bilinear
from lss2_multimodal_nu_tpu_torch.config import Config
from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
from lss2_multimodal_nu_tpu_torch.ops.sampling import resize_bilinear
from lss2_multimodal_nu_tpu_torch.train import steps as tsteps

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _locations(kind, rng, bh, npts, n, h, w):
    """lx, ly (bh, npts, n) float32 of one kind. "edges": uniform over [0, 1]
    (the main path clamps its locations there, and the JAX kernel takes
    them so), a tenth exactly 0 (x0 = -1: corners 00 and 10 outside), a
    tenth exactly 1, a fifth on cell edges (lx * w - 0.5 whole); "outside":
    uniform over [-0.3, 1.3], so that some points have no corner inside;
    "one_cell": every point inside the cell of corner 00 (w // 2, h // 3),
    at uniform places in it."""
    if kind == "one_cell":
        u = rng.uniform(0.02, 0.98, size=(2, bh, npts, n))
        lx = (w // 2 + 0.5 + u[0]) / w
        ly = (h // 3 + 0.5 + u[1]) / h
        return lx.astype(np.float32), ly.astype(np.float32)
    if kind == "outside":
        return tuple(rng.uniform(-0.3, 1.3, (bh, npts, n)).astype(np.float32) for _ in "xy")
    out = []
    for size in (w, h):
        r = rng.uniform(0, 1, (bh, npts, n))
        edge = (rng.integers(0, size, (bh, npts, n)) + 0.5) / size
        loc = rng.uniform(0, 1, (bh, npts, n))
        loc = np.where(r < 0.1, 0.0, np.where(r < 0.2, 1.0, np.where(r < 0.4, edge, loc)))
        out.append(loc.astype(np.float32))
    return tuple(out)


# (h, w, n queries, locations, chunk): ragged maps and query counts; chunk 3
# cuts the cells of more than 3 points into pieces (every cell in "one_cell")
CASES = {
    "9x7_edges": (9, 7, 60, "edges", ds.DV_CHUNK),
    "9x7_edges_chunk3": (9, 7, 60, "edges", 3),
    "5x11_edges_chunk1": (5, 11, 53, "edges", 1),
    "7x6_outside": (7, 6, 41, "outside", ds.DV_CHUNK),
    "7x6_outside_chunk2": (7, 6, 41, "outside", 2),
    "8x8_one_cell": (8, 8, 61, "one_cell", ds.DV_CHUNK),
    "8x8_one_cell_chunk3": (8, 8, 61, "one_cell", 3),
    "6x10_one_cell_chunk7": (6, 10, 47, "one_cell", 7),
}
DH, NPTS, BH = 32, 4, 3  # dh=32: the TPU kernel wants 4*dh = 128


def _inputs(name):
    h, w, n, kind, chunk = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    v = rng.normal(size=(BH, DH, h * w)).astype(np.float32)  # channel-major, as JAX
    lx, ly = _locations(kind, rng, BH, NPTS, n, h, w)
    attn = rng.uniform(0, 1, size=(BH, NPTS, n)).astype(np.float32)
    g = rng.normal(size=(BH, n, DH)).astype(np.float32)
    return (h, w, chunk), v, lx, ly, attn, g


@pytest.fixture(scope="module")
def jax_dv():
    """{case: dv of the JAX package's backward `_bwd_pallas` in the Pallas
    interpreter, channel-last}, with the quadrant-replicated cotangent its
    forward's contract asks for; not for the points outside [0, 1], which
    its contract leaves to the caller's clamp."""
    old = dp._INTERPRET
    dp._INTERPRET = True
    try:
        out = {}
        for name in CASES:
            if CASES[name][3] == "outside":
                continue
            (h, w, _), v, lx, ly, attn, g = _inputs(name)
            res = tuple(map(jnp.asarray, (v, lx, ly, attn)))
            got = jax.jit(lambda r, c, h=h, w=w: dp._bwd_pallas(h, w, r, c))(
                res, jnp.tile(jnp.asarray(g), (1, 1, 4)))
            out[name] = np.asarray(got[0]).transpose(0, 2, 1)
        return out
    finally:
        dp._INTERPRET = old


@pytest.mark.parametrize("name", list(CASES))
def test_ordered_dv_matches_plain_and_jax(name, jax_dv):
    """The kernel's order of the dv sums, in PyTorch calls, against the
    explicit backward's scatter-add and (locations in [0, 1]) the JAX
    kernel's backward: float32, 1e-5 of the largest |dv| (sums of the same
    terms in other orders)."""
    (h, w, chunk), v, lx, ly, attn, g = _inputs(name)
    v_cl = T(np.ascontiguousarray(v.transpose(0, 2, 1)))
    got = ds.deformable_dv_ordered_plain(T(lx), T(ly), T(attn), T(g), h, w, chunk=chunk)
    plain = ds.deformable_sample_combine_xy_backward_plain(v_cl, T(lx), T(ly), T(attn), T(g),
                                                           h, w)[0]
    assert got.shape == (BH, h * w, DH) and got.dtype == torch.float32
    for want in (plain.numpy(), jax_dv.get(name, plain.numpy())):
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale, rtol=0)


def test_ordered_dv_pieces_change_only_the_order():
    """All in one cell with chunk 1, 2 and 1000 (every point its own piece,
    pieces of two, one walk): the same dv up to float32 rounding, and the
    same bits on a second call."""
    (h, w, _), _, lx, ly, attn, g = _inputs("8x8_one_cell")
    args = (T(lx), T(ly), T(attn), T(g), h, w)
    runs = {c: ds.deformable_dv_ordered_plain(*args, chunk=c) for c in (1, 2, 1000)}
    scale = float(runs[1000].abs().max())
    for c in (1, 2):
        assert float((runs[c] - runs[1000]).abs().max()) <= 1e-6 * scale, c
    assert torch.equal(runs[2], ds.deformable_dv_ordered_plain(*args, chunk=2))


@pytest.mark.parametrize("name", ["9x7_edges", "7x6_outside", "8x8_one_cell"])
def test_dv_csr_matches_numpy_stable_argsort(name):
    """The points' keys (map * cells + the bordered cell of corner 00, or
    past every cell when no corner is inside) by numpy, sorted by numpy's
    stable argsort: the same order and row offsets as `dv_csr_plain`."""
    (h, w, _), _, lx, ly, _, _ = _inputs(name)
    fx = lx * np.float32(w) - np.float32(0.5)
    fy = ly * np.float32(h) - np.float32(0.5)
    x0, y0 = np.floor(fx), np.floor(fy)
    live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    cells = (h + 1) * (w + 1)
    key = np.arange(BH).reshape(-1, 1, 1) * cells + (y0 + 1) * (w + 1) + x0 + 1
    key = np.where(live, key, BH * cells).astype(np.int64).reshape(-1)
    order, rowptr = ds.dv_csr_plain(T(lx), T(ly), h, w)
    want = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(rowptr.numpy(),
                                  np.searchsorted(key[want], np.arange(BH * cells + 1)))
    assert rowptr.numel() == BH * cells + 1 and int(rowptr[-1]) == int(live.sum())
    if name == "9x7_edges":
        assert (x0 == -1).any() and (x0 == w - 1).any() and live.all()
    if name == "7x6_outside":
        assert (~live).any() and live.any()


# (input hw, output hw, align_corners): the Up block's x4 (`nn/layers.py`,
# align_corners=True), the depth net's c4 -> c3 size (`nn/depth_net.py`,
# False), BevEncode's x2 (`nn/lss_modules.py`, True), and down in both
RESIZES = [((5, 5), (20, 20), True), ((4, 11), (8, 22), False), ((10, 10), (20, 20), True),
           ((8, 22), (4, 11), False), ((8, 22), (3, 7), True), ((4, 11), (8, 22), True),
           ((10, 10), (20, 20), False), ((1, 6), (3, 1), False)]


@pytest.mark.parametrize("in_hw,out_hw,align", RESIZES)
def test_resize_matches_jax_forward_and_vjp(in_hw, out_hw, align):
    """The port's resize (NCHW) against the JAX package's (NHWC) and its
    gradient (autograd through the two products) against `jax.vjp`, for one
    cotangent: float32, 1e-6."""
    rng = np.random.default_rng(sum(in_hw) + sum(out_hw) + align)
    x = rng.normal(size=(2, 3, *in_hw)).astype(np.float32)
    cot = rng.normal(size=(2, 3, *out_hw)).astype(np.float32)
    xt = T(x).requires_grad_()
    got = resize_bilinear(xt, out_hw, align)
    got.backward(T(cot))
    want, vjp = jax.vjp(lambda a: j_resize_bilinear(a, out_hw, align),
                        jnp.asarray(x.transpose(0, 2, 3, 1)))
    (want_grad,) = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad).transpose(0, 3, 1, 2),
                               atol=1e-6, rtol=0)


def test_resize_matches_interpolate_and_keeps_dtype():
    """The matrix form computes `F.interpolate(mode="bilinear")` (1e-5:
    torch's kernel makes its weights in float32, the matrices in float64
    rounded once), and in bfloat16 stays bfloat16; a resize to its own size
    is the identity."""
    x = torch.randn(2, 4, 6, 9, generator=torch.Generator().manual_seed(0))
    for align in (False, True):
        want = torch.nn.functional.interpolate(x, size=(12, 5), mode="bilinear",
                                               align_corners=align)
        torch.testing.assert_close(resize_bilinear(x, (12, 5), align), want, atol=1e-5, rtol=0)
    assert resize_bilinear(x.bfloat16(), (12, 5), False).dtype == torch.bfloat16
    assert resize_bilinear(x, (6, 9), True) is x


def test_resize_first_made_in_inference_mode_then_trained():
    """A resize first called in an inference-mode forward (an evaluation
    before training) leaves matrices that a training step's backward can
    save: its gradient flows."""
    torch.manual_seed(1)
    size = (13, 7)  # a size no other test uses: its matrices are made here first
    with torch.inference_mode():
        resize_bilinear(torch.randn(1, 2, 5, 3), size, False)
    x = torch.randn(1, 2, 5, 3, requires_grad=True)
    resize_bilinear(x, size, False).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


class _Probe(torch.nn.Module):
    """A one-layer stand-in for a model, recording the cuDNN flag in its
    forward and in its backward."""

    def __init__(self, seen):
        super().__init__()
        self.cfg = Config()
        self.conv = torch.nn.Conv2d(3, 2, 3)
        self.seen = seen

    def forward(self, imgs, *calibration):
        self.seen.append(("forward", torch.backends.cudnn.deterministic))
        out = self.conv(imgs.flatten(0, 1))
        out.register_hook(lambda g: self.seen.append(("backward",
                                                      torch.backends.cudnn.deterministic)))
        return out


def _probe_step(monkeypatch, loss):
    """(the flags the probe saw, a function running one `train_step` of it
    with `loss` in place of the family's loss)."""
    seen = []
    model = _Probe(seen).train()
    monkeypatch.setattr(tsteps, "compute_loss", loss)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
    batch = {k: torch.zeros(1, 2, 3, 5, 5) if k == "imgs" else torch.zeros(1)
             for k in tsteps.MODEL_INPUTS}
    return seen, lambda: tsteps.train_step(model, opt, sched, batch, 0)


@pytest.mark.parametrize("caller", [False, True])
def test_train_step_pins_deterministic_cudnn(monkeypatch, caller):
    """Inside `train_step`, forward and backward, cuDNN is held to
    deterministic algorithms; the caller's value is back after the step."""
    seen, step = _probe_step(monkeypatch, lambda cfg, out, batch: (out.square().mean(),
                                                                   {"loss": out.sum()}))
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = caller
    try:
        metrics = step()
        assert torch.backends.cudnn.deterministic is caller
    finally:
        torch.backends.cudnn.deterministic = old
    assert seen == [("forward", True), ("backward", True)]
    assert torch.isfinite(metrics["grad_norm"])


def test_train_step_restores_cudnn_flag_after_an_exception(monkeypatch):
    """A step that raises inside leaves the caller's value as it was."""
    def fails(cfg, out, batch):
        raise RuntimeError("loss failed")

    seen, step = _probe_step(monkeypatch, fails)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        with pytest.raises(RuntimeError, match="loss failed"):
            step()
        assert torch.backends.cudnn.deterministic is False
    finally:
        torch.backends.cudnn.deterministic = old
    assert seen == [("forward", True)]
