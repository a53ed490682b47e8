"""The port's config, grid, frustum, geometry and resize against the golden
values of test_core.py and against the JAX package on the same inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.core.frustum import create_frustum as j_create_frustum
from lss2_multimodal_nu_tpu.core.geometry import get_geometry as j_get_geometry
from lss2_multimodal_nu_tpu.core.geometry import voxel_indices as j_voxel_indices
from lss2_multimodal_nu_tpu.core.grid import gen_dx_bx as j_gen_dx_bx
from lss2_multimodal_nu_tpu.ops.sampling import resize_bilinear as j_resize_bilinear
from lss2_multimodal_nu_tpu_torch import config as tconfig
from lss2_multimodal_nu_tpu_torch.core.frustum import create_frustum
from lss2_multimodal_nu_tpu_torch.core.geometry import get_geometry, invert_3x3, voxel_indices
from lss2_multimodal_nu_tpu_torch.core.grid import gen_dx_bx
from lss2_multimodal_nu_tpu_torch.ops.sampling import resize_bilinear

GRID = tconfig.GridConfig()
T = torch.from_numpy


def test_config_defaults_match_jax():
    """Same fields and defaults, minus the TPU-only knob; the port adds
    ln_eps (flax's LayerNorm default)."""
    pairs = ((jconfig.GridConfig, tconfig.GridConfig), (jconfig.AugConfig, tconfig.AugConfig),
             (jconfig.ModelConfig, tconfig.ModelConfig))
    for jcls, tcls in pairs:
        jd = {f.name: getattr(jcls(), f.name) for f in dataclasses.fields(jcls)}
        td = {f.name: getattr(tcls(), f.name) for f in dataclasses.fields(tcls)}
        jd.pop("dropout_rng_impl", None)
        assert td.pop("ln_eps", 1e-6) == 1e-6
        assert jd == td, jcls.__name__
    assert tconfig.GridConfig().nx == jconfig.GridConfig().nx
    assert tconfig.ModelConfig(compute_dtype="bfloat16").torch_dtype == torch.bfloat16


def test_gen_dx_bx_golden():
    dx, bx, nx = gen_dx_bx(GRID.xbound, GRID.ybound, GRID.zbound)
    np.testing.assert_allclose(dx, [0.5, 0.5, 20.0])
    np.testing.assert_allclose(bx, [-49.75, -49.75, 0.0])
    np.testing.assert_array_equal(nx, [200, 200, 1])
    for a, b in zip((dx, bx, nx), j_gen_dx_bx(GRID.xbound, GRID.ybound, GRID.zbound)):
        np.testing.assert_array_equal(a, b)
    assert GRID.nx == (200, 200, 1) and GRID.num_depth_bins == 41


def test_frustum_golden_and_equal_to_jax():
    fr = create_frustum((128, 352), GRID.dbound, 16)
    assert fr.shape == (41, 8, 22, 3)
    np.testing.assert_allclose(fr[:, 0, 0, 2], np.arange(4.0, 45.0))
    assert fr[0, 0, -1, 0] == 351 and fr[0, -1, 0, 1] == 127
    np.testing.assert_array_equal(fr, j_create_frustum((128, 352), GRID.dbound, 16))


def test_invert_3x3_matches_numpy():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(4, 6, 3, 3)).astype(np.float32) + np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(invert_3x3(T(m)).numpy(), np.linalg.inv(m), rtol=2e-4, atol=2e-4)


def _identity_cams(b=2, n=3):
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)).copy()
    trans = np.zeros((b, n, 3), dtype=np.float32)
    intr = rots.copy()
    post_r = rots.copy()
    post_t = np.zeros((b, n, 3), dtype=np.float32)
    return rots, trans, intr, post_r, post_t


def test_geometry_golden():
    """Identity cameras give (u*d, v*d, d); a rotation about z and a
    translation act on the unprojected rays (test_core.py's goldens)."""
    fr = create_frustum((128, 352), GRID.dbound, 16)
    cam = np.concatenate([fr[..., :2] * fr[..., 2:3], fr[..., 2:3]], axis=-1)
    pts = get_geometry(T(fr), *map(T, _identity_cams())).numpy()
    assert pts.shape == (2, 3, 41, 8, 22, 3)
    np.testing.assert_allclose(pts[0, 0], cam, rtol=1e-5, atol=1e-5)

    rots, trans, intr, post_r, post_t = _identity_cams(1, 1)
    trans[0, 0] = [1.0, -2.0, 3.0]
    rz = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32)
    rots[0, 0] = rz
    pts = get_geometry(T(fr), *map(T, (rots, trans, intr, post_r, post_t))).numpy()
    np.testing.assert_allclose(pts[0, 0], cam @ rz.T + trans[0, 0], rtol=1e-4, atol=1e-4)


def _calib(rng, b=2, n=6, h=128, w=352):
    q, _ = np.linalg.qr(rng.normal(size=(b, n, 3, 3)))
    rots = q.astype(np.float32)
    trans = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    intr = np.broadcast_to(
        np.array([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1.0]], np.float32), (b, n, 3, 3)
    ).copy()
    intr[..., 0, 0] += rng.uniform(-50, 50, (b, n)).astype(np.float32)
    post_r = np.broadcast_to(np.eye(3, dtype=np.float32) * (w / 1600.0), (b, n, 3, 3)).copy()
    post_r[..., 2, 2] = 1.0
    post_r[..., 0, 1] = rng.uniform(-0.01, 0.01, (b, n)).astype(np.float32)
    post_t = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    post_t[..., 2] = 0.0
    return rots, trans, intr, post_r, post_t


def test_geometry_and_voxels_match_jax():
    """Random rotations, intrinsics and augmentation affines. Both compute in
    float32 with the adjugate inverse; the sums are taken in another order,
    so points agree to float32 rounding of ~50 m coordinates (1e-4 m), and
    the voxel indices (0.5 m cells) agree except where a point lies within
    that rounding of a cell edge."""
    rng = np.random.default_rng(3)
    fr = create_frustum((128, 352), GRID.dbound, 16)
    calib = _calib(rng)
    got = get_geometry(T(fr), *map(T, calib))
    want = np.asarray(j_get_geometry(jnp.asarray(fr), *map(jnp.asarray, calib)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

    dx, bx, nx = gen_dx_bx(GRID.xbound, GRID.ybound, GRID.zbound)
    idx, valid = voxel_indices(got, dx, bx, nx)
    jidx, jvalid = j_voxel_indices(jnp.asarray(got.numpy()), dx, bx, nx)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < int(valid.sum()) < valid.numel()


def test_voxel_indices_truncate_toward_zero():
    """`.to(int32)` truncates like torch's `.long()`: a point 0.05 m below
    the low edge lands in voxel 0 and stays valid (floor would drop it)."""
    dx, bx, nx = gen_dx_bx(GRID.xbound, GRID.ybound, GRID.zbound)
    geom = np.array(
        [[bx[0] - dx[0] / 2.0 - 0.05, bx[1] - dx[1] / 2.0 + 0.2, 0.0],
         [0.0, 0.0, 0.0], [-49.9, -49.9, -9.9], [55.0, 0.0, 0.0], [0.0, 0.0, 25.0]],
        dtype=np.float32,
    )
    idx, valid = voxel_indices(T(geom), dx, bx, nx)
    assert idx[0].tolist() == [0, 0, 0]
    assert valid.tolist() == [True, True, True, False, False]
    assert idx[1, 0] == 100 and idx[1, 2] == 0


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("hw", [(4, 11), (8, 22), (3, 3)])
def test_resize_bilinear_matches_jax(hw, align_corners):
    """Both resizes are the same two interpolation-matrix products, the
    port's in PyTorch on NCHW, JAX's on NHWC; float32 (1e-5 for rounding)."""
    x = np.random.default_rng(1).normal(size=(2, 5, 4, 11)).astype(np.float32)
    got = resize_bilinear(T(x), hw, align_corners).numpy()
    want = np.asarray(j_resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)), hw, align_corners))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5)
