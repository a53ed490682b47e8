"""The port's modules against the JAX package's, eval mode, float32.

One random JAX variable tree of the flagship (made from a numpy seed, with
shapes from `jax.eval_shape`, so nothing is compiled for init) is carried
into the port by `state_dict_from_jax`. Each JAX submodule then runs with
its own subtree, and the port's counterpart with the loaded weights, on the
same numpy inputs. JAX runs its XLA paths on the CPU (the fused FFN tail
also through the Pallas interpreter); the port its plain paths.

Tolerances: both sides compute in float32 but in different orders (cuDNN
style direct convs against XLA's, another GELU/erf), so values of order 1
agree to ~1e-5 after a few layers; the deep trunk is held to 1e-4 relative
to its largest activation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu.config import AugConfig as JAug, Config as JConfig
from lss2_multimodal_nu_tpu.config import GridConfig as JGrid, ModelConfig as JModel
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.nn import depth_net as jdepth, fusion as jfusion
from lss2_multimodal_nu_tpu.nn import lss_modules as jlss, transformer as jtr
from lss2_multimodal_nu_tpu.nn.vovnet import VoVNetV2 as JVoVNetV2
from lss2_multimodal_nu_tpu.ops import ffn_pallas as fp
from lss2_multimodal_nu_tpu_torch.config import AugConfig, Config, GridConfig, ModelConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.port import state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    own threads in each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy
XB = (-8.0, 8.0, 0.5)  # the dryrun grid: 32 x 32 BEV
FINAL_DIM = (32, 96)


def random_variables(module, args, seed):
    """{params, batch_stats} of `module` with random numpy values: He-normal
    kernels, biases N(0, 0.1), norm scales and BN variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        name = keys[-1]
        if keys[0] == "batch_stats":
            a = rng.normal(0, 0.1, s.shape) if name == "mean" else rng.uniform(0.5, 1.5, s.shape)
        elif name == "kernel":
            a = rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-1])), s.shape)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.normal(0, 0.1, s.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def camera_inputs(b, n=6, h=FINAL_DIM[0], w=FINAL_DIM[1], seed=0):
    """JAX-layout (B, N, H, W, 3) images and calibration, from numpy."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(b, n, h, w, 3)).astype(np.float32)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)).copy()
    trans = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    intr = np.broadcast_to(
        np.array([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1.0]], np.float32), (b, n, 3, 3)
    ).copy()
    post_r = np.broadcast_to(np.eye(3, dtype=np.float32) * (w / 1600.0), (b, n, 3, 3)).copy()
    post_r[..., 2, 2] = 1.0
    post_t = np.zeros((b, n, 3), np.float32)
    return imgs, rots, trans, intr, post_r, post_t


@pytest.fixture(scope="module")
def flagship():
    """(JAX variables, port model) of the V3 flagship at the dryrun grid."""
    jcfg = JConfig(grid=JGrid(xbound=XB, ybound=XB), aug=JAug(final_dim=FINAL_DIM),
                   model=JModel(family="vovnet_transformer"))
    cfg = Config(grid=GridConfig(xbound=XB, ybound=XB), aug=AugConfig(final_dim=FINAL_DIM),
                 model=ModelConfig(family="vovnet_transformer"))
    variables = random_variables(j_build_model(jcfg), camera_inputs(1), seed=0)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    return variables, model


def sub(variables, *path):
    """The {params[, batch_stats]} subtree of one submodule."""
    out = {}
    for coll in ("params", "batch_stats"):
        node = variables[coll]
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if node:
            out[coll] = node
    return out


def nchw(a):
    return T(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def close(got, want, atol, rel=False):
    want = np.asarray(want)
    scale = np.abs(want).max() if rel else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol * scale)


def test_vovnet_trunk(flagship):
    """c3 (stride 16) and c4 (stride 32) at 64x176, the flagship's width
    halved: the ceil-mode pools see widths 44 and 22, whose last window
    overhangs the edge, and 11 (352 / 32 at the flagship)."""
    variables, model = flagship
    x = np.random.default_rng(1).normal(size=(2, 64, 176, 3)).astype(np.float32)
    want = JVoVNetV2("vovnet39").apply(sub(variables, "backbone"), jnp.asarray(x))
    with torch.inference_mode():
        got = model.backbone(nchw(x))
    assert got["c3"].shape == (2, 768, 4, 11) and got["c4"].shape == (2, 1024, 2, 5)
    for k in ("c3", "c4"):
        close(got[k], np.moveaxis(np.asarray(want[k]), -1, 1), 1e-4, rel=True)


def test_depth_net_and_cam_encode(flagship):
    variables, model = flagship
    rng = np.random.default_rng(2)
    c3 = rng.normal(size=(2, 4, 11, 768)).astype(np.float32)
    c4 = rng.normal(size=(2, 2, 5, 1024)).astype(np.float32)
    want = jdepth.MultiScaleDepthNet(41).apply(sub(variables, "depth_net"), *map(jnp.asarray, (c3, c4)))
    feat = jdepth.CamEncodeV2(out_features=128).apply(sub(variables, "cam_encode"), jnp.asarray(c3))
    with torch.inference_mode():
        got = model.depth_net(nchw(c3), nchw(c4))
        got_feat = model.cam_encode(nchw(c3))
    assert got.shape == (2, 41, 4, 11)
    torch.testing.assert_close(got.sum(1), torch.ones(2, 4, 11))
    close(got, np.moveaxis(np.asarray(want), -1, 1), 1e-5)
    close(got_feat, np.moveaxis(np.asarray(feat), -1, 1), 1e-4)


def _tokens(seed, b=2, h=16, w=16, c=256):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, h * w, c)).astype(np.float32)
    pos = jtr.sine_position_embedding(h, w, c // 2).reshape(1, h * w, c)
    ys, xs = np.linspace(0, 1, h, dtype=np.float32), np.linspace(0, 1, w, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    ref = np.stack([gx, gy], axis=-1).reshape(h * w, 2)
    return src, pos, ref


def test_deformable_attention(flagship):
    """Offsets (head, point, xy), both divided by h, clamped; softmax over
    points; folded output through a plain output_proj."""
    variables, model = flagship
    src, pos, ref = _tokens(3)
    path = ("bev_encoder", "transformer", "encoder", "self_attn")
    q = src + pos
    want = jtr.DeformableAttention(256, 8).apply(sub(variables, *path), *map(jnp.asarray, (q, src, ref)))
    with torch.inference_mode():
        got = model.bev_encoder.transformer.encoder.self_attn(*map(T, (q, src, ref)))
    close(got, want, 1e-4)


@pytest.mark.parametrize("jax_tail", ["xla", "pallas_interpret"])
def test_transformer_encoder_layer(flagship, jax_tail):
    """Eval encoder layer; the tail is LN(eps 1e-6) -> exact-erf GELU FFN ->
    residual -> LN(eps 1e-6), against JAX's XLA modules and its fused kernel
    in the interpreter."""
    variables, model = flagship
    src, pos, ref = _tokens(4)
    old = fp._INTERPRET
    fp._INTERPRET = jax_tail == "pallas_interpret"
    try:
        layer = jtr.TransformerEncoderLayer(256, 8, 1024, 0.1)
        want = jax.jit(lambda v, *a: layer.apply(v, *a, train=False))(
            sub(variables, "bev_encoder", "transformer", "encoder"),
            *map(jnp.asarray, (src, pos, ref)))
    finally:
        fp._INTERPRET = old
    with torch.inference_mode():
        got = model.bev_encoder.transformer.encoder(*map(T, (src, pos, ref)))
    close(got, want, 1e-4)


def test_bev_encoder_with_folded_seg_head(flagship):
    """Compress -> transformer -> seg head with BN folded (the port) against
    JAX's unfolded ConvBN XLA path, on the 32x32 dryrun grid."""
    variables, model = flagship
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 128)).astype(np.float32)
    seg, refined = jfusion.BEVEncoderTransformer(4).apply(sub(variables, "bev_encoder"), jnp.asarray(x))
    with torch.inference_mode():
        got_seg, got_ref = model.bev_encoder(nchw(x))
    assert got_seg.shape == (2, 4, 32, 32) and got_ref.shape == (2, 256, 32, 32)
    close(got_ref, np.moveaxis(np.asarray(refined), -1, 1), 1e-4)
    close(got_seg, np.moveaxis(np.asarray(seg), -1, 1), 1e-4)


def test_txt_heads(flagship):
    """Feature pyramid, SceneUnder/ASPP (rates 12/24/36, broadcast pool
    branch), camera self-attention, BEV-camera cross-attention and the
    unified predictor, each on its own inputs."""
    variables, model = flagship
    rng = np.random.default_rng(6)
    c3 = rng.normal(size=(6, 4, 11, 768)).astype(np.float32)
    pyr = jfusion.AdaptiveFeaturePyramid(256).apply(sub(variables, "feature_pyramid"), jnp.asarray(c3))
    scene_in = rng.normal(size=(6, 4, 11, 256)).astype(np.float32)
    scene = jlss.SceneUnder().apply(sub(variables, "sceneunder"), jnp.asarray(scene_in))
    cams = rng.normal(size=(2, 6, 256)).astype(np.float32)
    ids = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    cam_t = jfusion.LightweightCameraTransformer(n_cameras=6).apply(
        sub(variables, "camera_transformer"), jnp.asarray(cams), jnp.asarray(ids))
    bev = rng.normal(size=(2, 8, 8, 256)).astype(np.float32)
    fused = jfusion.BEVCameraFusion().apply(sub(variables, "bev_fusion"), *map(jnp.asarray, (cams, bev)))
    act, desc = jfusion.UnifiedPredictor(4, 8, 6).apply(sub(variables, "unified_predictor"), jnp.asarray(cams))
    with torch.inference_mode():
        close(model.feature_pyramid(nchw(c3)), np.moveaxis(np.asarray(pyr), -1, 1), 1e-4)
        close(model.sceneunder(nchw(scene_in)), np.moveaxis(np.asarray(scene), -1, 1), 1e-4)
        close(model.camera_transformer(T(cams), T(ids.astype(np.int64))), cam_t, 1e-4)
        close(model.bev_fusion(T(cams), nchw(bev)), fused, 1e-4)
        got_act, got_desc = model.unified_predictor(T(cams))
        close(got_act, act, 1e-5)
        close(got_desc, desc, 1e-5)
