"""Each CUDA kernel's plain PyTorch version against the JAX package's Pallas
kernel, run in the Pallas interpreter as the JAX tests run it on the CPU, and
the gradients of the autograd Functions around the kernels.

The wrappers take the plain version for a CPU tensor; for any other device
that is not a CUDA card they raise (no silent fallback). The eval-only
kernels refuse a call that autograd would have to differentiate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu.ops import deformable_pallas as dp
from lss2_multimodal_nu_tpu.ops import ffn_pallas as fp
from lss2_multimodal_nu_tpu.ops import lift_splat as jls
from lss2_multimodal_nu_tpu.ops import lift_splat_pallas as lsp
from lss2_multimodal_nu_tpu.ops import seg_head_pallas as sp
from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
from lss2_multimodal_nu_tpu_torch.ops import ffn
from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh

T = torch.from_numpy
BF16_ULP = 2.0 ** -7  # relative spacing of bfloat16 near 1


@pytest.fixture(autouse=True)
def _interpret_on_cpu():
    mods = (dp, lsp, fp, sp)
    old = [m._INTERPRET for m in mods]
    for m in mods:
        m._INTERPRET = True
    yield
    for m, o in zip(mods, old):
        m._INTERPRET = o


def _deform_inputs(h, w, bh=4, dh=32, npts=4, seed=11, n=None):
    """v (BH, dh, H*W) channel-major as JAX takes it; n queries (H*W unless
    given)."""
    rng = np.random.default_rng(seed)
    n = h * w if n is None else n
    v = rng.normal(size=(bh, dh, h * w)).astype(np.float32)
    lx = rng.uniform(0, 1, size=(bh, npts, n)).astype(np.float32)
    ly = rng.uniform(0, 1, size=(bh, npts, n)).astype(np.float32)
    # exact-edge samples: corners outside the map must read zero
    lx[:, 0, :4] = [0.0, 1.0, 0.0, 1.0]
    ly[:, 0, :4] = [0.0, 0.0, 1.0, 1.0]
    attn = rng.uniform(0, 1, size=(bh, npts, n)).astype(np.float32)
    return v, lx, ly, attn


@pytest.mark.parametrize("hw", [(16, 16), (12, 12), (16, 12)])
def test_deformable_plain_matches_pallas(hw):
    """Kernel 1. The port takes v channel-last (BH, H*W, dh); the JAX kernel
    channel-major. float32 throughout; 1e-5 covers the sum order."""
    h, w = hw
    v, lx, ly, attn = _deform_inputs(h, w)
    want = jax.jit(lambda *a: dp.deformable_sample_combine_pallas_xy(*a, h, w))(
        *map(jnp.asarray, (v, lx, ly, attn)))
    v_cl = T(np.ascontiguousarray(v.transpose(0, 2, 1)))
    got = ds.deformable_sample_combine_xy_plain(v_cl, T(lx), T(ly), T(attn), h, w)
    assert got.shape == (4, h * w, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_deformable_wrapper_cpu_is_plain_and_bf16():
    """On the CPU the wrapper is the plain version and launches nothing. In
    bfloat16 the sum runs in float32 and is rounded once: one bf16 ulp."""
    h = w = 12
    v, lx, ly, attn = _deform_inputs(h, w, seed=2)
    v_cl = T(np.ascontiguousarray(v.transpose(0, 2, 1)))
    args = (T(lx), T(ly), T(attn), h, w)
    before = ds.deformable_sample_combine_xy.launches
    f32 = ds.deformable_sample_combine_xy(v_cl, *args)
    assert ds.deformable_sample_combine_xy.launches == before
    torch.testing.assert_close(f32, ds.deformable_sample_combine_xy_plain(v_cl, *args))
    bf = ds.deformable_sample_combine_xy(v_cl.bfloat16(), *args)
    assert bf.dtype == torch.bfloat16
    ref = ds.deformable_sample_combine_xy_plain(v_cl.bfloat16().float(), *args)
    assert float((bf.float() - ref).abs().max()) <= BF16_ULP * float(ref.abs().max())


def _cl(v):
    """JAX's channel-major value maps -> the port's channel-last ones."""
    return T(np.ascontiguousarray(v.transpose(0, 2, 1)))


@pytest.mark.parametrize("hw", [(16, 16), (12, 12), (16, 12)])
def test_deformable_backward_plain_matches_pallas(hw):
    """Kernel 2's plain version against the JAX kernel backward `_bwd_pallas`
    in the interpreter (dh=32: the TPU kernel wants 4*dh = 128), with H*W - 3
    queries (no multiple of 8) and the exact-edge samples. JAX's cotangent is
    the quadrant-replicated one its forward's contract asks for, and its dv
    is channel-major. float32; 1e-4 relative as the JAX package's own
    backward test, for the rc differences that cancel."""
    h, w = hw
    n = h * w - 3
    v, lx, ly, attn = _deform_inputs(h, w, dh=32, n=n, seed=h + w)
    g = np.random.default_rng(1).normal(size=(4, n, 32)).astype(np.float32)
    res = tuple(map(jnp.asarray, (v, lx, ly, attn)))
    want = jax.jit(lambda r, c: dp._bwd_pallas(h, w, r, c))(res, jnp.tile(jnp.asarray(g), (1, 1, 4)))
    got = ds.deformable_sample_combine_xy_backward_plain(_cl(v), T(lx), T(ly), T(attn), T(g), h, w)
    want = [np.asarray(want[0]).transpose(0, 2, 1), *map(np.asarray, want[1:])]
    for name, a, b in zip(("dv", "dlx", "dly", "dattn"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("dh", [32, 20])
def test_deformable_backward_plain_matches_autograd(dh):
    """The explicit backward against torch.autograd through the plain
    forward (7x9 map, 60 queries, exact-edge samples); float32, 1e-5
    relative for the sum order."""
    h, w = 7, 9
    v, lx, ly, attn = _deform_inputs(h, w, dh=dh, n=60, seed=dh)
    g = T(np.random.default_rng(2).normal(size=(4, 60, dh)).astype(np.float32))
    leaves = [t.requires_grad_() for t in (_cl(v), T(lx), T(ly), T(attn))]
    (ds.deformable_sample_combine_xy_plain(*leaves, h, w) * g).sum().backward()
    got = ds.deformable_sample_combine_xy_backward_plain(*[t.detach() for t in leaves], g, h, w)
    for name, a, leaf in zip(("dv", "dlx", "dly", "dattn"), got, leaves):
        b = leaf.grad
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


def test_deformable_function_gradients_on_cpu():
    """Through `deformable_sample_combine_xy` (the autograd Function) on the
    CPU: gradients reach v, lx, ly and attn, equal to the explicit backward,
    in the inputs' dtypes (v bfloat16 here), and no kernel is counted."""
    h, w = 6, 5
    v, lx, ly, attn = _deform_inputs(h, w, dh=32, n=30, seed=4)
    g = T(np.random.default_rng(3).normal(size=(4, 30, 32)).astype(np.float32)).bfloat16()
    leaves = [_cl(v).bfloat16().requires_grad_()] + [T(a).requires_grad_() for a in (lx, ly, attn)]
    counters = (ds.deformable_sample_combine_xy, ds.deformable_sample_combine_xy_backward)
    before = [f.launches for f in counters]
    out = ds.deformable_sample_combine_xy(*leaves, h, w)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    (out.float() * g.float()).sum().backward()
    want = ds.deformable_sample_combine_xy_backward_plain(*[t.detach() for t in leaves], g, h, w)
    for leaf, b in zip(leaves, want):
        assert leaf.grad is not None and leaf.grad.dtype == leaf.dtype
        torch.testing.assert_close(leaf.grad, b)
    assert [f.launches for f in counters] == before


def test_lift_splat_backward_matches_jax_vjp():
    """The lift-splat Function's backward against `jax.vjp` of the JAX
    package's `_fused_lift_splat_op` (Pallas forward in the interpreter, the
    XLA backward `_fused_bwd`): dfeat and ddepth to 1e-5 (sums of a few
    float32 terms); seg and fidx get none."""
    feat, depth, seg, fidx, nv = _splat_inputs(seed=5)
    g = np.random.default_rng(6).normal(size=(2, nv, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda f, d: jls._fused_lift_splat_op(f, d, jnp.asarray(seg), jnp.asarray(fidx), nv),
                     jnp.asarray(feat), jnp.asarray(depth))
    want_feat, want_depth = vjp(jnp.asarray(g))
    tf, td = T(feat).requires_grad_(), T(depth).requires_grad_()
    ts_, ti = T(seg), T(fidx)
    out = ls.fused_lift_splat(tf, td, ts_, ti, nv)
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_feat), atol=1e-5)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_depth), atol=1e-5)
    dfeat, ddepth = ls.fused_lift_splat_backward(tf.detach(), td.detach(), ts_, ti, T(g))
    torch.testing.assert_close(dfeat, tf.grad)
    torch.testing.assert_close(ddepth, td.grad)


def test_eval_only_kernels_refuse_gradients():
    """fused_ffn_ln and fused_seg_head write through raw pointers and have no
    backward, so off the CPU (a meta tensor stands in for a CUDA one) a call
    that autograd would differentiate raises before any launch, instead of
    returning a result with no gradient; under no_grad it goes on to the
    device check."""
    m = lambda *s: torch.empty(*s, dtype=torch.float32, device="meta")
    w1 = m(256, 1024).requires_grad_()
    ffn_args = (m(1, 4, 256), w1, m(1024), m(1024, 256), m(256), m(256), m(256), m(256), m(256))
    seg_args = (m(1, 16, 256), m(3, 3, 256, 128).requires_grad_(), m(128), m(3, 3, 128, 64),
                m(64), m(64, 4), m(4), 4, 4)
    before = (ffn.fused_ffn_ln.launches, sh.fused_seg_head.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        ffn.fused_ffn_ln(*ffn_args, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        sh.fused_seg_head(*seg_args)
    with torch.no_grad():
        with pytest.raises(ValueError):
            ffn.fused_ffn_ln(*ffn_args, compute_dtype=torch.float32)
        with pytest.raises(ValueError):
            sh.fused_seg_head(*seg_args)
    assert (ffn.fused_ffn_ln.launches, sh.fused_seg_head.launches) == before


def _splat_inputs(seed=0, b=2, r=24, p=300, c=16, n_voxels=256):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(b, r, c)).astype(np.float32)
    depth = rng.uniform(0, 1, size=(b, p)).astype(np.float32)
    depth[rng.uniform(size=(b, p)) < 0.3] = 0.0  # invalid points
    seg = rng.integers(0, n_voxels, size=(b, p)).astype(np.int32)
    fidx = rng.integers(0, r, size=(b, p)).astype(np.int32)
    return feat, depth, seg, fidx, n_voxels


def test_lift_splat_plain_matches_pallas():
    """Kernel 3 on float32 features; sums of up to ~5 terms, 1e-5."""
    feat, depth, seg, fidx, nv = _splat_inputs()
    want = jax.jit(lambda *a: lsp.fused_lift_splat(*a, nv))(
        *map(jnp.asarray, (feat, depth, seg, fidx)))
    got = ls.fused_lift_splat_plain(*map(T, (feat, depth, seg, fidx)), nv)
    assert got.shape == (2, nv, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lift_splat_plain_matches_pallas_bf16():
    """bfloat16 features: both sum in float32 and round once at the end,
    so they differ by at most one bf16 ulp of the output."""
    feat, depth, seg, fidx, nv = _splat_inputs(seed=1)
    fb = jnp.asarray(feat).astype(jnp.bfloat16)
    want = jax.jit(lambda *a: lsp.fused_lift_splat(*a, nv))(
        fb, *map(jnp.asarray, (depth, seg, fidx)))
    got = ls.fused_lift_splat(T(feat).bfloat16(), *map(T, (depth, seg, fidx)), nv)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= BF16_ULP * np.abs(want).max()


def test_lift_splat_module_matches_jax():
    """`lift_splat` end to end (seg/fidx/depth prepared as in the JAX
    module, then the z-major collapse) with two z levels, against the JAX
    module on its fused Pallas path. JAX returns (B, X, Y, Z*C); the port
    (B, Z*C, X, Y)."""
    rng = np.random.default_rng(4)
    b, n, d, fh, fw, c, nxy, nz = 2, 3, 5, 4, 6, 16, 8, 2
    nx = np.array([nxy, nxy, nz])
    feat = rng.normal(size=(b, n, fh, fw, c)).astype(np.float32)
    depth = rng.uniform(0, 1, size=(b, n, d, fh, fw)).astype(np.float32)
    idx = rng.integers(0, nxy, size=(b, n, d, fh, fw, 3)).astype(np.int32)
    idx[..., 2] = rng.integers(0, nz, size=idx.shape[:-1])
    valid = rng.uniform(size=(b, n, d, fh, fw)) > 0.3
    want = jls.lift_splat(*map(jnp.asarray, (feat, depth, idx, valid)), nx)
    got = ls.lift_splat(T(np.ascontiguousarray(feat.transpose(0, 1, 4, 2, 3))),
                        *map(T, (depth, idx, valid)), nx)
    assert got.shape == (b, nz * c, nxy, nxy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=1e-5)


def _ffn_params(rng, c, f):
    g = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (g(c, f, scale=0.05), g(f), g(f, c, scale=0.05), g(c),
            1 + g(c, scale=0.1), g(c, scale=0.1), 1 + g(c, scale=0.1), g(c, scale=0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_plain_matches_pallas(dtype):
    """Kernel 4 with a row count that is no multiple of the kernel's tile.
    float32: 2e-5 (the JAX kernel's erf is XLA's rational approximation,
    the port's is libm's; both are float32-exact to a few ulps). bfloat16:
    LN1's output, the GELU output and the weights are rounded to bf16 in
    both, so the output differs by a flipped rounding, one bf16 ulp of the
    largest output."""
    rng = np.random.default_rng(0)
    b, n, c, f = 2, 100, 128, 256
    u = rng.normal(size=(b, n, c)).astype(np.float32)
    params = _ffn_params(rng, c, f)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax.jit(lambda *a: fp.fused_ffn_ln(*a, eps=1e-6, compute_dtype=jdt))(
        jnp.asarray(u).astype(jdt), *map(jnp.asarray, params))
    want = np.asarray(want.astype(jnp.float32))
    got = ffn.fused_ffn_ln(T(u).to(tdt), *map(T, params), eps=1e-6, compute_dtype=tdt)
    assert got.dtype == tdt and got.shape == (b, n, c)
    tol = 2e-5 if dtype == "float32" else 2 * BF16_ULP * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)


def _seg_params(rng, b, h, w):
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (f(b, h * w, 256, scale=0.5), f(3, 3, 256, 128, scale=0.05), f(128),
            f(3, 3, 128, 64, scale=0.05), f(64), f(64, 4, scale=0.1), f(4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_head_plain_matches_pallas(dtype):
    """Kernel 5 on a 10x12 map (every pixel is near a border, where the
    second conv's zero halo matters). float32: 2e-4 for the 2304-term sums.
    bfloat16: the conv operands and conv0's output are bf16 in both, sums in
    float32; a flipped rounding of conv0's output moves a logit by far less
    than 1e-2 of the logits' range."""
    rng = np.random.default_rng(0)
    b, h, w = 2, 10, 12
    x, *wts = _seg_params(rng, b, h, w)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax.jit(lambda x_, *a: sp.fused_seg_head(x_, *a, h, w))(
        jnp.asarray(x).astype(jdt), *map(jnp.asarray, wts))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    got = sh.fused_seg_head(T(x).to(tdt), *map(T, wts), h, w)
    assert got.dtype == torch.float32 and got.shape == (b, 4, h, w)
    tol = 2e-4 if dtype == "float32" else 1e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


def test_fold_conv_bn_matches_jax():
    rng = np.random.default_rng(5)
    k = rng.normal(size=(3, 3, 8, 6)).astype(np.float32)
    bias, gamma, beta, mean = (rng.normal(size=6).astype(np.float32) for _ in range(4))
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    want = sp.fold_conv_bn(*map(jnp.asarray, (k, bias, gamma, beta, mean, var)))
    got = sh.fold_conv_bn(*map(T, (k, bias, gamma, beta, mean, var)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_wrappers_raise_off_the_card():
    """A tensor that is neither on the CPU nor on a CUDA card has no plain
    fallback: every wrapper raises before launching anything."""
    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
    counted = (ds.deformable_sample_combine_xy, ds.deformable_sample_combine_xy_backward,
               ls.fused_lift_splat, ffn.fused_ffn_ln, sh.fused_seg_head)
    before = [f.launches for f in counted]
    with pytest.raises(ValueError):
        ds.deformable_sample_combine_xy(m(4, 16, 32), m(4, 2, 16), m(4, 2, 16), m(4, 2, 16), 4, 4)
    with pytest.raises(ValueError):
        ds.deformable_sample_combine_xy_backward(m(4, 16, 32), m(4, 2, 16), m(4, 2, 16),
                                                 m(4, 2, 16), m(4, 16, 32), 4, 4)
    with pytest.raises(ValueError):
        ls.fused_lift_splat(m(1, 4, 8), m(1, 5), m(1, 5, dt=torch.int32),
                            m(1, 5, dt=torch.int32), 8)
    with pytest.raises(ValueError):
        ffn.fused_ffn_ln(m(1, 4, 256), m(256, 1024), m(1024), m(1024, 256), m(256),
                         m(256), m(256), m(256), m(256), compute_dtype=torch.float32)
    with pytest.raises(ValueError):
        sh.fused_seg_head(m(1, 16, 256), m(3, 3, 256, 128), m(128), m(3, 3, 128, 64), m(64),
                          m(64, 4), m(4), 4, 4)
    assert [f.launches for f in counted] == before
