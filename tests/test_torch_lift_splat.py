"""The lift-splat kernels' index preparation and their reductions over it,
on the CPU, against numpy and the JAX package; and the port's float32
precision pinned at its entry points whatever torch's TF32 flags say.

`ops/lift_splat.py::sort_points` builds the CSR that both CUDA kernels walk:
points keyed by (row << bbits) | b (a point with depth 0 after every row),
sorted stably, with each row's offset into the sorted list. Its plain
version, which the CPU takes, is held here against numpy at the edge cases;
the card's (a keys kernel, a radix sort and a binary search per row) is
held against the plain version bit for bit in
`tests/test_torch_kernels_cuda.py`. The forward and backward
kernels' arithmetic over that CSR, written out in numpy (each row's points
summed one by one in sorted order, in float32), is held against the JAX
package's Pallas forward in the interpreter and its `jax.vjp`: atol 1e-5,
sums of a few float32 terms of magnitude about 1 in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lss2_multimodal_nu_tpu.ops import lift_splat as jls
from lss2_multimodal_nu_tpu.ops import lift_splat_pallas as lsp
from lss2_multimodal_nu_tpu_torch.config import AugConfig, Config, GridConfig, ModelConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.ops import ffn
from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh
from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32
from lss2_multimodal_nu_tpu_torch.train import state as ts
from lss2_multimodal_nu_tpu_torch.train import steps as tsteps

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _interpret_on_cpu():
    old = lsp._INTERPRET
    lsp._INTERPRET = True
    yield
    lsp._INTERPRET = old


def _points(case, seed=0):
    """(row (B, P) int32, weight (B, P) float32 or None, n_rows) of one case."""
    rng = np.random.default_rng(seed)
    b, p, n_rows = 3, 200, 40
    row = rng.integers(0, n_rows, size=(b, p)).astype(np.int32)
    weight = rng.uniform(0.1, 1, size=(b, p)).astype(np.float32)
    if case == "mixed":  # depth-0 points and empty voxels in every batch element
        weight[rng.uniform(size=(b, p)) < 0.3] = 0.0
    elif case == "batch_element_without_points":
        weight[1] = 0.0
    elif case == "one_voxel_takes_every_point":
        row[:] = 7
    elif case == "no_weights":  # the backward's CSR over fidx
        weight = None
    return row, weight, n_rows


def _bbits(b):
    return (b - 1).bit_length()


def _numpy_csr(row, weight, n_rows):
    """order and rowptr by the CSR's definition: keys (row << bbits) | b,
    the dead points' row n_rows, sorted stably."""
    b, p = row.shape
    live = np.ones((b, p), bool) if weight is None else weight != 0
    key = ((np.where(live, row, n_rows) << _bbits(b)) | np.arange(b)[:, None]).reshape(-1)
    order = np.argsort(key, kind="stable")
    n_keys = n_rows << _bbits(b)
    return order, np.searchsorted(key[order], np.arange(n_keys + 1), side="left"), key


@pytest.mark.parametrize("case", ["mixed", "batch_element_without_points",
                                  "one_voxel_takes_every_point", "no_weights"])
def test_sort_points_matches_numpy(case):
    row, weight, n_rows = _points(case)
    order, rowptr = ls.sort_points(T(row), None if weight is None else T(weight), n_rows)
    assert order.dtype == torch.int32 and rowptr.dtype == torch.int32
    want_order, want_ptr, key = _numpy_csr(row, weight, n_rows)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(rowptr.numpy(), want_ptr)
    b, p = row.shape
    bbits = _bbits(b)
    n_live = p * b if weight is None else int((weight != 0).sum())
    assert rowptr[-1] == n_live  # depth-0 points sort after every row and are never visited
    for k in range(n_rows << bbits):  # each run holds its row's points in point order
        run = order[rowptr[k]:rowptr[k + 1]].numpy()
        assert (key[run] == k).all() and (np.diff(run) > 0).all()
        assert (run // p == k & ((1 << bbits) - 1)).all()
    if case == "batch_element_without_points":
        empty = [((r << bbits) | 1) for r in range(n_rows)]  # batch element 1's rows
        assert all(rowptr[k + 1] == rowptr[k] for k in empty)
    if case == "one_voxel_takes_every_point":
        for bb in range(b):
            k = (7 << bbits) | bb
            assert rowptr[k + 1] - rowptr[k] == p


def test_sort_points_refuses_a_row_out_of_range():
    row, weight, n_rows = _points("mixed")
    live = np.argwhere(weight != 0)[0]
    row[tuple(live)] = n_rows
    with pytest.raises(ValueError, match="outside"):
        ls.sort_points(T(row), T(weight), n_rows)
    weight[tuple(live)] = 0.0  # a depth-0 point's row is never read
    ls.sort_points(T(row), T(weight), n_rows)


def _splat_case(case, seed):
    rng = np.random.default_rng(seed)
    b, r, p, c, nv = 2, 24, 300, 16, 256
    if case == "one_voxel_takes_every_point":
        p = 64
    feat = rng.normal(size=(b, r, c)).astype(np.float32)
    depth = rng.uniform(0, 1, size=(b, p)).astype(np.float32)
    depth[rng.uniform(size=(b, p)) < 0.3] = 0.0
    seg = rng.integers(0, nv, size=(b, p)).astype(np.int32)
    seg[depth == 0] = 0  # as `lift_splat` prepares them
    if case == "one_voxel_takes_every_point":
        seg[:] = 9
    fidx = rng.integers(0, r, size=(b, p)).astype(np.int32)
    fidx[fidx == 5] = 6  # feature row 5 has no points
    return feat, depth, seg, fidx, nv


def _interval_sum(feat, depth, fidx, order, rowptr, nv):
    """The forward kernel's arithmetic: each output row sums its run of
    sorted points one by one in float32; an empty row is zero."""
    b, r, c = feat.shape
    p = depth.shape[1]
    out = np.zeros((b, nv, c), np.float32)
    for bb in range(b):
        for v in range(nv):
            key = (v << _bbits(b)) | bb
            acc = np.zeros(c, np.float32)
            for i in order[rowptr[key]:rowptr[key + 1]]:
                ib, pp = divmod(int(i), p)
                assert ib == bb
                acc = acc + depth[bb, pp] * feat[bb, fidx[bb, pp]]
            out[bb, v] = acc
    return out


@pytest.mark.parametrize("case", ["mixed", "one_voxel_takes_every_point"])
def test_interval_sum_matches_pallas(case):
    feat, depth, seg, fidx, nv = _splat_case(case, seed=3)
    order, rowptr = ls.sort_points(T(seg), T(depth), nv)
    got = _interval_sum(feat, depth, fidx, order.numpy(), rowptr.numpy(), nv)
    want = jax.jit(lambda *a: lsp.fused_lift_splat(*a, nv))(
        *map(jnp.asarray, (feat, depth, seg, fidx)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got, ls.fused_lift_splat_plain(*map(T, (feat, depth, seg, fidx)), nv).numpy(), atol=1e-5)


def _csr_backward(feat, depth, seg, g, order, ptr):
    """The backward kernel's arithmetic: each feature row walks its points
    through the CSR over fidx, writes each point's ddepth once and sums
    depth * g over them in float32."""
    b, r, c = feat.shape
    p = depth.shape[1]
    dfeat = np.zeros_like(feat)
    ddepth = np.full((b, p), np.nan, np.float32)
    for row in range(b * r):
        bb, rr = divmod(row, r)
        key = (rr << _bbits(b)) | bb
        acc = np.zeros(c, np.float32)
        for i in order[ptr[key]:ptr[key + 1]]:
            ib, ip = divmod(int(i), p)
            assert ib == bb
            g_row = g[bb, seg[bb, ip]]
            ddepth[bb, ip] = np.dot(g_row, feat[bb, rr])
            acc = acc + depth[bb, ip] * g_row
        dfeat[bb, rr] = acc
    return dfeat, ddepth


@pytest.mark.parametrize("case", ["mixed", "one_voxel_takes_every_point"])
def test_fidx_csr_backward_matches_jax_vjp(case):
    """Every point gets its ddepth, depth 0 or not (an invalid point's is
    <g[b, 0], feat>, as JAX's `_fused_bwd` gives), and a feature row with no
    points gets a zero dfeat."""
    feat, depth, seg, fidx, nv = _splat_case(case, seed=5)
    g = np.random.default_rng(6).normal(size=(2, nv, feat.shape[2])).astype(np.float32)
    order, ptr = ls.sort_points(T(fidx), None, feat.shape[1])
    dfeat, ddepth = _csr_backward(feat, depth, seg, g, order.numpy(), ptr.numpy())
    assert not np.isnan(ddepth).any()
    assert (ddepth[depth == 0] != 0).all() and (dfeat[:, 5] == 0).all()
    _, vjp = jax.vjp(lambda f, d: jls._fused_lift_splat_op(f, d, jnp.asarray(seg),
                                                          jnp.asarray(fidx), nv),
                     jnp.asarray(feat), jnp.asarray(depth))
    want_feat, want_depth = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dfeat, np.asarray(want_feat), atol=1e-5)
    np.testing.assert_allclose(ddepth, np.asarray(want_depth), atol=1e-5)


def test_bindings_match_the_c_entry_points():
    """Each ctypes binding of the lift-splat libraries names as many
    arguments as its `extern "C"` entry point in `csrc/` takes: ctypes would
    refuse a call otherwise, and only on the card."""
    import re
    from pathlib import Path

    csrc = Path(ls.__file__).resolve().parent.parent / "csrc"
    source = "".join((csrc / f).read_text() for f in ("lift_splat.cu", "lift_splat_backward.cu"))
    for symbol, argtypes in ls._ARGTYPES.items():
        m = re.search(r'extern "C" \w+ ' + symbol + r"\(([^)]*)\)", source)
        assert m, symbol
        assert len(m.group(1).split(",")) == len(argtypes), symbol


def test_cached_constants_made_in_inference_mode_serve_training():
    """The frustum's fidx and the grid's constants are cached at their first
    use; a first use under `torch.inference_mode` (an eval) must not make
    them inference tensors, which a later training step could not save for
    its backward."""
    rng = np.random.default_rng(12)
    b, n, d, fh, fw, c = 1, 2, 3, 3, 7, 8  # a shape no other test uses
    nx = np.array([4, 4, 1])
    feat = T(rng.normal(size=(b, n, c, fh, fw)).astype(np.float32))
    depth = T(rng.uniform(size=(b, n, d, fh, fw)).astype(np.float32))
    idx = T(rng.integers(0, 4, size=(b, n, d, fh, fw, 3)).astype(np.int32))
    idx[..., 2] = 0
    valid = T(rng.uniform(size=(b, n, d, fh, fw)) > 0.3)
    with torch.inference_mode():
        want = ls.lift_splat(feat, depth, idx, valid, nx)
    feat.requires_grad_()
    got = ls.lift_splat(feat, depth, idx, valid, nx)
    got.sum().backward()
    torch.testing.assert_close(got.detach(), want)
    assert feat.grad is not None


# ---- float32 precision pinned at the port's entry points


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()


@pytest.fixture
def tf32_defaults():
    """torch's default cuDNN flag and a training script's usual matmul
    setting, "high" (TF32 allowed): the port must compute in full float32
    under them and leave them as it found them."""
    old = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield (True, "high")
    torch.backends.cudnn.allow_tf32 = old[0]
    torch.set_float32_matmul_precision(old[1])


def test_full_float32_restores_the_flags_after_an_exception(tf32_defaults):
    with pytest.raises(RuntimeError, match="inside"):
        with full_float32():
            assert _flags() == (False, "highest")
            raise RuntimeError("inside")
    assert _flags() == tf32_defaults


def _tiny_model_and_batch():
    xb = (-4.0, 4.0, 0.5)
    cfg = Config(grid=GridConfig(xbound=xb, ybound=xb), aug=AugConfig(final_dim=(32, 96)),
                 model=ModelConfig(family="vovnet_transformer"))
    model = build_model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(2)
    b, n = 1, 6
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)).copy()
    intr = np.broadcast_to(np.array([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1.0]],
                                    np.float32), (b, n, 3, 3)).copy()
    post_r = np.broadcast_to(np.eye(3, dtype=np.float32) * (96 / 1600.0), (b, n, 3, 3)).copy()
    post_r[..., 2, 2] = 1.0
    arrays = (rng.normal(size=(b, n, 3, 32, 96)).astype(np.float32), rots,
              rng.normal(0, 1, (b, n, 3)).astype(np.float32), intr, post_r,
              np.zeros((b, n, 3), np.float32))
    batch = dict(zip(tsteps.MODEL_INPUTS, map(T, arrays)),
                 binimg=T(rng.integers(0, 4, size=(b, 16, 16))),
                 act=T((rng.random((b, 4)) < 0.4).astype(np.float32)),
                 desc=T((rng.random((b, 8)) < 0.4).astype(np.float32)))
    return model, batch


def test_entry_points_pin_full_float32(tf32_defaults):
    """Hooks on the trunk's first conv (the stem's first conv-BN-ReLU block)
    and on its weight's gradient record the flags inside the forward, inside
    the train step's backward (which runs outside the model's forward) and
    inside the eval step; after each entry point returns, the caller's flags
    are back."""
    model, batch = _tiny_model_and_batch()
    block = model.backbone.backbone.stem[0]
    seen = []
    block.register_forward_hook(lambda m, i, o: seen.append(("forward", _flags())))
    block.conv.weight.register_hook(lambda g: seen.append(("backward", _flags())))
    full = (False, "highest")

    with torch.no_grad():
        model(*(batch[k] for k in tsteps.MODEL_INPUTS))
    assert seen == [("forward", full)] and _flags() == tf32_defaults

    seen.clear()
    opt, sched = ts.build_optimizer(model.cfg, tsteps.train_without_dropout(model))
    tsteps.train_step(model, opt, sched, batch, 0)
    assert seen == [("forward", full), ("backward", full)] and _flags() == tf32_defaults

    seen.clear()
    confmat = torch.zeros(4, 4, dtype=torch.int64)
    tsteps.eval_step(model.eval(), batch, confmat)
    assert seen == [("forward", full)] and _flags() == tf32_defaults


def test_plain_versions_pin_full_float32(tf32_defaults, monkeypatch):
    """The seg head's and the FFN tail's plain versions reach cuDNN and the
    matrix products, so a kernel-against-plain check holds under torch's
    defaults too."""
    seen = []
    conv2d, matmul = F.conv2d, torch.matmul
    monkeypatch.setattr(F, "conv2d", lambda *a, **k: seen.append(_flags()) or conv2d(*a, **k))
    monkeypatch.setattr(torch, "matmul", lambda *a, **k: seen.append(_flags()) or matmul(*a, **k))
    rng = np.random.default_rng(9)
    g = lambda *s: T(rng.normal(size=s).astype(np.float32) * 0.1)
    sh.fused_seg_head_plain(g(1, 16, 256), g(3, 3, 256, 128), g(128), g(3, 3, 128, 64), g(64),
                            g(64, 4), g(4), 4, 4)
    ffn.fused_ffn_ln_plain(g(1, 4, 256), g(256, 1024), g(1024), g(1024, 256), g(256),
                           g(256), g(256), g(256), g(256), compute_dtype=torch.float32)
    assert seen == [(False, "highest")] * 4 and _flags() == tf32_defaults
