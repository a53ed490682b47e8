"""Stack A in the port against the JAX package, float32, on the CPU: the
EfficientNet trunk's block table and endpoints, the eval forwards of
`BevTxt` (b4), `BevTxtOnlyBev` (b0) and `LSS` (b0), the weights' round trip
through the JAX package's porter, the losses, one `BevTxt` train step, the
dropouts and drop-connects, where the TXT loss sends its gradient, the
one-group optimizer and the cached loss weights.

The models run at the full input size (6 cameras at 128x352 into the
200x200 grid): BevTxt's BEV crop (80x88, pooled to 8x22) must meet the
camera features (128x352 / 16). Weights are random numpy values with shapes
from `jax.eval_shape` (`test_torch_modules.py::random_variables`), carried
into the port by `state_dict_from_jax`. Dropout and drop-connect are off on
both sides of a train-step comparison: flax's `Dropout` and the JAX
package's `nn.efficientnet.drop_connect` are patched to identities here,
the port's model goes through `train_without_dropout`.

Tolerances: the full-model ones of `test_torch_model.py` (2e-3 on the BEV
logits, 1e-3 on act/desc); the train step's those of `test_torch_train.py`.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lss2_multimodal_nu_tpu.nn.efficientnet as jeff
from lss2_multimodal_nu_tpu.config import Config as JConfig, ModelConfig as JModel
from lss2_multimodal_nu_tpu.config import TrainConfig as JTrain
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.nn.lss_modules import Embedder as JEmbedder
from lss2_multimodal_nu_tpu.port.torch_port import port_state_dict
from lss2_multimodal_nu_tpu.train import losses as jl, metrics as jm, state as js
from lss2_multimodal_nu_tpu.train import steps as jsteps
from lss2_multimodal_nu_tpu_torch.config import Config, ModelConfig, TrainConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.nn import efficientnet as teff
from lss2_multimodal_nu_tpu_torch.nn.layers import DropConnect
from lss2_multimodal_nu_tpu_torch.nn.lss_modules import Embedder
from lss2_multimodal_nu_tpu_torch.port import state_dict_from_jax
from lss2_multimodal_nu_tpu_torch.train import losses as tl, state as ts, steps as tsteps
from test_torch_modules import camera_inputs, random_variables
from test_torch_train import (_flat, _grad_capture, _loss_inputs, _nchw, _no_flax_dropout,
                              _port_dropout_calls, _recording_flax_dropout)

T = torch.from_numpy
H, W, GRID = 128, 352, 200
VARIANTS = {"bev_txt": "b4", "bev_txt_onlybev": "b0", "lss": "b0"}


def _configs(family, variant, **train):
    jcfg = JConfig(model=JModel(family=family, effnet_variant=variant),
                   train=JTrain(dropout_rng_impl="threefry", **train))
    cfg = Config(model=ModelConfig(family=family, effnet_variant=variant),
                 train=TrainConfig(**train))
    return jcfg, cfg


def _port_args(args):
    """JAX-layout camera inputs -> the port's (images NCHW per camera)."""
    return [T(np.ascontiguousarray(args[0].transpose(0, 1, 4, 2, 3)))] + [T(a) for a in args[1:]]


def _port_model(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                              family=cfg.model.family,
                                              effnet_variant=cfg.model.effnet_variant))
    return model


def _calibrated(cfg, variables, args):
    """`variables` with every batch norm's running statistics set to its
    batch statistics on `args` (one train forward of the port with momentum
    1, carried back through the JAX package's porter), so that each batch
    norm normalises its input as a trained model's does. With the raw random
    statistics, activations grow through the deep trunk and the ResNet body
    to BEV logits of order 1e3, where float32's round-off (1e-7 relative)
    alone exceeds the absolute tolerances; calibrated, they are of order 1."""
    model = tsteps.train_without_dropout(_port_model(cfg, variables))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model(*_port_args(args))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _, batch_stats, missing = port_state_dict(cfg.model.family, sd,
                                              variant=cfg.model.effnet_variant)
    assert not missing
    return {"params": variables["params"], "batch_stats": batch_stats}


@contextlib.contextmanager
def _jax_drop_connect_as(fn):
    orig = jeff.drop_connect
    jeff.drop_connect = fn
    try:
        yield
    finally:
        jeff.drop_connect = orig


def _no_jax_stochastic():
    """flax's Dropout and the trunk's drop_connect as identities."""
    stack = contextlib.ExitStack()
    stack.enter_context(_no_flax_dropout())
    stack.enter_context(_jax_drop_connect_as(lambda x, rate, deterministic, rng: x))
    return stack


def test_build_model_defaults_to_the_card():
    """`build_model` puts Stack A on the card unless the caller asks for the
    CPU; without a card it raises, it does not fall back."""
    _, cfg = _configs("lss", "b0")
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert not model.training and next(model.parameters()).device.type == "cpu"


# ---- (a) the trunk's block table, pure Python


def _jax_block_table(variant):
    """The JAX trunk's walk of `static_same_pad`, `round_filters` and
    `round_repeats` (`nn/efficientnet.py::EfficientNetTrunk`), without a
    compile."""
    width, depth = jeff.SCALING[variant]
    stem_ch = jeff.round_filters(32, width)
    stem_pad, size = jeff.static_same_pad(jeff.IMAGE_SIZE[variant], 3, 2)
    blocks, in_ch = [], stem_ch
    for expand, k, s, c, r in jeff.BASE_STAGES:
        out_ch = jeff.round_filters(c, width)
        for i in range(jeff.round_repeats(r, depth)):
            blocks.append([in_ch, out_ch, expand, k, s if i == 0 else 1])
            in_ch = out_ch
    for idx, blk in enumerate(blocks):
        pad, size = jeff.static_same_pad(size, blk[3], blk[4])
        blk += [pad, 0.2 * idx / len(blocks)]
    return stem_ch, stem_pad, [tuple(b) for b in blocks]


@pytest.mark.parametrize("variant", list(jeff.SCALING))
def test_trunk_block_table_matches_jax(variant):
    """Channels, repeats, kernel, stride, the static pad and the
    drop-connect rate of every block, and the constants they come from."""
    assert teff.SCALING == jeff.SCALING and teff.BASE_STAGES == jeff.BASE_STAGES
    assert teff.IMAGE_SIZE == jeff.IMAGE_SIZE
    assert teff.trunk_blocks(variant) == _jax_block_table(variant)
    assert teff.encoder_channels(variant) == jeff.encoder_channels(variant)
    if variant == "b4":  # built for 95 rows, the third stride pads (2, 2), not (1, 2)
        assert _jax_block_table("b4")[2][6][3:6] == (5, 2, (2, 2))


def test_mbconv_shapes_follow_the_reference():
    """SE width from the block's input channels, depthwise groups = mid,
    batch norm eps 1e-3 / momentum 0.01, residual only at stride 1 and
    in == out, no expand conv at ratio 1."""
    trunk = teff.EfficientNetTrunk("b4")
    first, strided, plain = trunk._blocks[0], trunk._blocks[2], trunk._blocks[3]
    assert not hasattr(first, "_expand_conv") and first.residual is False
    mid = plain._depthwise_conv.out_channels
    assert plain._depthwise_conv.groups == mid and plain._depthwise_conv.weight.shape[1] == 1
    assert plain._se_reduce.out_channels == int(plain._expand_conv.in_channels * 0.25)
    assert plain.residual and not strided.residual
    assert plain._bn1.eps == 1e-3 and plain._bn1.momentum == 0.01
    assert strided._pad == (0, 1, 0, 1) and strided._depthwise_conv.padding == (0, 0)
    assert trunk._blocks[6]._pad is None and trunk._blocks[6]._depthwise_conv.padding == (2, 2)


# ---- (b) the trunk's endpoints at b4


@pytest.fixture(scope="module")
def lss_b4_variables():
    jcfg, cfg = _configs("lss", "b4")
    args = camera_inputs(1, h=H, w=W)
    return _calibrated(cfg, random_variables(j_build_model(jcfg), args, seed=3), args)


def test_trunk_endpoints_match_jax(lss_b4_variables):
    """b4 on 2x3x128x352 (other images than the calibration's): every
    reduction endpoint within 1e-4 of its largest magnitude (the deep trunk
    in float32, summed in other orders)."""
    v = lss_b4_variables
    x = np.random.default_rng(4).normal(size=(2, H, W, 3)).astype(np.float32)
    trunk_vars = {"params": v["params"]["encoder"]["trunk"],
                  "batch_stats": v["batch_stats"]["encoder"]["trunk"]}
    want = jax.jit(lambda vv, xx: jeff.EfficientNetTrunk("b4").apply(vv, xx, train=False))(
        trunk_vars, jnp.asarray(x))
    _, cfg = _configs("lss", "b4")
    model = _port_model(cfg, v)
    with torch.inference_mode():
        got = model.encoder.trunk(T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert sorted(got) == sorted(want) == [f"reduction_{i}" for i in range(1, 6)]
    for k in want:
        w_ = np.moveaxis(np.asarray(want[k]), 3, 1)
        assert got[k].shape == w_.shape, k
        np.testing.assert_allclose(got[k].numpy(), w_, atol=1e-4 * np.abs(w_).max(), err_msg=k)


# ---- (c) the eval forwards, (d) the weights' round trip


@pytest.fixture(scope="module", params=list(VARIANTS))
def stack(request):
    family = request.param
    jcfg, cfg = _configs(family, VARIANTS[family])
    args = camera_inputs(1, h=H, w=W, seed=11)
    jmodel = j_build_model(jcfg)
    variables = _calibrated(cfg, random_variables(jmodel, args, seed=17), args)
    return family, jcfg, cfg, jmodel, variables, args


@pytest.fixture(scope="module")
def forwards(stack):
    family, _, cfg, jmodel, variables, args = stack
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(variables,
                                                                   *map(jnp.asarray, args))
    with torch.inference_mode():
        got = _port_model(cfg, variables)(*_port_args(args))
    if family == "lss":
        want, got = (want,), (got,)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_forward_matches_jax(stack, forwards):
    """B=1: BEV within 2e-3, act/desc within 1e-3."""
    family = stack[0]
    want, got = forwards
    want_bev = np.moveaxis(want[0], 3, 1)
    assert got[0].shape == (1, 4, GRID, GRID)
    assert np.abs(want_bev).max() > 0.1  # the check is not vacuous
    np.testing.assert_allclose(got[0], want_bev, atol=2e-3)
    print(f"{family}: BEV max |diff| {np.abs(got[0] - want_bev).max():.3g} of max "
          f"|BEV| {np.abs(want_bev).max():.3g}")
    if family != "lss":
        assert got[1].shape == (1, 4) and got[2].shape == (1, 8)
        for g_, w_ in zip(got[1:], want[1:]):
            assert np.abs(w_).max() > 0.01
            print(f"{family}: act/desc max |diff| {np.abs(g_ - w_).max():.3g}")
            np.testing.assert_allclose(g_, w_, atol=1e-3)


def test_weights_round_trip(stack):
    """JAX tree -> state_dict_from_jax -> the JAX package's porter -> the
    same tree, key for key and bit for bit; the port's model takes exactly
    the keys that state_dict_from_jax makes."""
    family, _, cfg, _, variables, _ = stack
    variant = VARIANTS[family]
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], family=family,
                             effnet_variant=variant)
    assert set(sd) == set(build_model(cfg, device="cpu").state_dict())
    params, batch_stats, missing = port_state_dict(
        family, {k: v.numpy() for k, v in sd.items()}, variant=variant)
    assert not missing
    for got, want in ((params, variables["params"]), (batch_stats, variables["batch_stats"])):
        flat_got, flat_want = _flat(got), _flat(want)
        # the JAX BevTxt builds its SceneUnder under `sceneunder`; every leaf maps
        assert flat_got.keys() == flat_want.keys()
        for k in flat_want:
            np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=k)


def test_eval_step_matches_jax(stack, forwards):
    """`eval_step`: its loss (`simple_loss` for LSS, `multi_loss` for the
    others) within 1e-5 relative of JAX's on JAX's forward; the confusion
    matrix equal to JAX's but where JAX's own top-2 margin is within the
    forward's agreement (2e-3); LSS predicts the BEV alone, the others also
    act/desc, equal to JAX's but where JAX's logit is within 1e-3 of 0."""
    family, _, cfg, _, variables, args = stack
    rng = np.random.default_rng(2)
    labels = dict(binimg=rng.integers(0, 4, size=(1, GRID, GRID)).astype(np.int32),
                  act=(rng.random((1, 4)) < 0.4).astype(np.float32),
                  desc=(rng.random((1, 8)) < 0.4).astype(np.float32))
    batch = dict(zip(tsteps.MODEL_INPUTS, _port_args(args)), binimg=T(labels["binimg"]).long(),
                 act=T(labels["act"]), desc=T(labels["desc"]))
    got = tsteps.eval_step(_port_model(cfg, variables), batch, torch.zeros(4, 4, dtype=torch.long))
    want = [jnp.asarray(w) for w in forwards[0]]
    lab = {k: jnp.asarray(v) for k, v in labels.items()}
    if family == "lss":
        assert set(got) == {"confmat", "loss", "bsize"}
        want_loss = jl.simple_loss(want[0], lab["binimg"])
    else:
        assert set(got) == {"confmat", "loss", "bsize", "act_pred", "desc_pred"}
        want_loss = jl.multi_loss(*want, lab["binimg"], lab["act"], lab["desc"])
        for k, logits in (("act_pred", forwards[0][1]), ("desc_pred", forwards[0][2])):
            flip = got[k].numpy() != (logits > 0)
            assert not (flip & (np.abs(logits) > 1e-3)).any(), k
    assert got["bsize"] == 1
    assert float(got["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    want_conf = np.asarray(jm.confusion_matrix_update(
        jnp.zeros((4, 4), jnp.int32), lab["binimg"], jnp.argmax(want[0], -1), 4))
    top2 = np.sort(forwards[0][0], axis=-1)[..., -2:]
    close = int((top2[..., 1] - top2[..., 0] < 2e-3).sum())
    assert np.abs(got["confmat"].numpy() - want_conf).sum() <= 2 * close


# ---- (e) the losses, (and the cached weights)


LOSSES = {
    "simple_loss": (lambda bev, lab, *_: jl.simple_loss(bev, lab),
                    lambda bev, lab, *_: tl.simple_loss(bev, lab)),
    "multi_loss": (lambda *a: jl.multi_loss(a[0], a[2], a[3], a[1], a[4], a[5]),
                   lambda *a: tl.multi_loss(a[0], a[2], a[3], a[1], a[4], a[5])),
    "multi_loss_nobev": (lambda bev, lab, act, desc, at, dt: jl.multi_loss_nobev(act, desc, at, dt),
                         lambda bev, lab, act, desc, at, dt: tl.multi_loss_nobev(act, desc, at, dt)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_stack_a_loss_matches_jax(name):
    """NHWC logits on the JAX side, NCHW on the port's; the same weights;
    atol 1e-5 (the nobev weights reach 400)."""
    for k in ("ACT_WEIGHTS", "DESC_WEIGHTS", "ACT_WEIGHTS_NOBEV", "DESC_WEIGHTS_NOBEV"):
        assert getattr(tl, k) == getattr(jl, k), k
    bev, labels, act, desc, act_t, desc_t = _loss_inputs(seed=len(name) + 40)
    jfn, tfn = LOSSES[name]
    want = float(jfn(*map(jnp.asarray, (bev, labels, act, desc, act_t, desc_t))))
    got = tfn(_nchw(bev), T(labels).long(), *map(T, (act, desc, act_t, desc_t)))
    assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-5 * max(1.0, abs(want))


def test_loss_weights_are_made_once_per_device():
    """Two calls of a loss on one device read one weight tensor: no copy
    from the host after the first."""
    bev, labels, act, desc, act_t, desc_t = _loss_inputs(seed=5)
    args = (_nchw(bev), T(act), T(desc), T(labels).long(), T(act_t), T(desc_t))
    first = tl._const(tl.DESC_WEIGHTS, T(desc))
    want = tl.multi_loss(*args)
    made = []
    orig = torch.tensor

    def recording(*a, **k):
        made.append(a[0])
        return orig(*a, **k)

    torch.tensor = recording
    try:
        assert float(tl.multi_loss(*args)) == float(want)
        tl.multi_task_loss(*args)
    finally:
        torch.tensor = orig
    assert made == [tuple(tl.ACT_POS_WEIGHT_V2), tuple(tl.DESC_POS_WEIGHT_V2)] or made == []
    assert tl._const(tl.DESC_WEIGHTS, T(desc)) is first
    assert tl._const(list(tl.DESC_WEIGHTS), T(act)) is first


# ---- (f) one BevTxt train step against make_train_step


@pytest.fixture(scope="module")
def bev_txt_step():
    """BevTxt b0 at B=1, lr 1e-4, wd 1e-8, the clip out of reach (it is held
    to optax's in test_one_group_optimizer_matches_optax): one step on each
    side, the JAX gradients captured by the optimizer, the n of every port
    batch norm (elements per channel) recorded."""
    train = dict(lr=1e-4, weight_decay=1e-8, max_grad_norm=1e6)
    jcfg, cfg = _configs("bev_txt", "b0", **train)
    args = camera_inputs(1, h=H, w=W, seed=21)
    jmodel = j_build_model(jcfg)
    variables = random_variables(jmodel, args, seed=23)
    rng = np.random.default_rng(25)
    labels = dict(binimg=rng.integers(0, 4, size=(1, GRID, GRID)).astype(np.int32),
                  act=(rng.random((1, 4)) < 0.4).astype(np.float32),
                  desc=(rng.random((1, 8)) < 0.4).astype(np.float32))
    jbatch = dict(zip(jsteps.MODEL_INPUTS, map(jnp.asarray, args)),
                  **{k: jnp.asarray(v) for k, v in labels.items()})
    tbatch = dict(zip(tsteps.MODEL_INPUTS, _port_args(args)), binimg=T(labels["binimg"]).long(),
                  act=T(labels["act"]), desc=T(labels["desc"]))
    tx = _grad_capture()
    state = js.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    with _no_jax_stochastic():
        new_state, jmetrics = jsteps.make_train_step(jcfg, jmodel)(state, jbatch,
                                                                   jax.random.PRNGKey(0))
    model = tsteps.train_without_dropout(_port_model(cfg, variables))
    opt, sched = ts.build_optimizer(cfg, model)
    counts, calls = {}, {}
    bn = torch.nn.functional.batch_norm

    def counting_bn(x, running_mean, running_var, *a, **k):
        counts[running_var.data_ptr()] = x.numel() // x.shape[1]
        calls[running_var.data_ptr()] = calls.get(running_var.data_ptr(), 0) + 1
        return bn(x, running_mean, running_var, *a, **k)

    stats0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    torch.nn.functional.batch_norm = counting_bn
    try:
        metrics = tsteps.train_step(model, opt, sched, tbatch, 0)
    finally:
        torch.nn.functional.batch_norm = bn
    n_of = {name: (counts[buf.data_ptr()], calls[buf.data_ptr()])
            for name, buf in model.named_buffers() if name.endswith("running_var")}
    return jmetrics, new_state, metrics, model, stats0, n_of


def test_bev_txt_train_step_loss_and_grad_norm_match_jax(bev_txt_step):
    """The loss within 1e-5 relative, grad_norm within 2e-3 relative."""
    jmetrics, _, metrics, *_ = bev_txt_step
    assert set(metrics) == {"loss", "grad_norm"}
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=2e-3)


def test_bev_txt_train_step_grads_match_jax(bev_txt_step):
    """Every leaf's gradient, carried back to the JAX layout through the JAX
    package's porter, under `test_torch_train.py`'s limits: leaves below
    1e-4 of the largest |grad| on the JAX side (zero in exact arithmetic)
    stay below 1e-3 of it on the port's; every other leaf is non-zero and
    within 0.25 in norm relative to JAX's, the median leaf within 0.06."""
    _, new_state, _, model, _, _ = bev_txt_step
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        sd[name] = p.grad.numpy()
    grads, _, missing = port_state_dict("bev_txt", sd, variant="b0")
    assert not missing
    got, want = _flat(grads), _flat(new_state.opt_state["grads"])
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    rel = {}
    for k in want:
        if np.abs(want[k]).max() <= 1e-4 * top:
            assert np.abs(got[k]).max() <= 1e-3 * top, k
        else:
            assert np.abs(got[k]).max() > 0, k
            rel[k] = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
    worst = max(rel.items(), key=lambda kv: kv[1])
    print(f"BevTxt b0 port vs JAX: per-leaf norm-relative gradient difference worst "
          f"{worst[1]:.3g} ({worst[0]}), median {np.median(list(rel.values())):.3g}")
    assert len(rel) > 0.9 * len(want)
    assert worst[1] <= 0.25 and np.median(list(rel.values())) <= 0.06, worst


def test_bev_txt_train_step_batch_norm_statistics_match_jax(bev_txt_step):
    """running_mean as JAX's mean; running_var against JAX's biased batch
    variance brought to torch's unbiased one by n/(n-1) (ROADMAP.md fault
    e), with each layer's momentum m (0.01 in the trunk, 0.1 elsewhere)
    applied once per call (`embeder_lr1` runs for four cameras: after k
    calls the old statistics weigh m^k); both within 2e-4 of the layer's
    largest value."""
    _, new_state, _, model, stats0, n_of = bev_txt_step
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd0 = dict(sd, **{k: v.numpy() for k, v in stats0.items()})
    port = functools.partial(port_state_dict, "bev_txt", variant="b0")
    _, bs_new, _ = port(sd)
    _, bs_old, _ = port(sd0)
    _, bs_n, _ = port(dict(sd, **{k: np.full_like(sd[k], n) for k, (n, _) in n_of.items()}))
    _, bs_k, _ = port(dict(sd, **{k: np.full_like(sd[k], c) for k, (_, c) in n_of.items()}))
    got, old, jax_new, ns, ks = (_flat(t) for t in (bs_new, bs_old, new_state.batch_stats, bs_n,
                                                      bs_k))
    assert got.keys() == jax_new.keys() and len(got) == 2 * len(n_of)
    assert sorted({int(c) for (_, c) in n_of.values()}) == [1, 4]
    for k in jax_new:
        if k.endswith("['var']"):
            n = ns[k]
            mk = (0.99 if "['trunk']" in k else 0.9) ** ks[k]
            want = mk * old[k] + (jax_new[k] - mk * old[k]) * n / (n - 1)
        else:
            want = jax_new[k]
        assert np.abs(got[k] - old[k]).max() > 0, k  # the statistics moved
        np.testing.assert_allclose(got[k], want, atol=2e-4 * np.abs(want).max(), err_msg=k)


# ---- (g) dropouts and drop-connects: places and rates


def _jax_stochastic_calls(jmodel, args):
    """(dropouts as (top-level module, rate), drop-connect rates) of one JAX
    train forward, traced by `jax.eval_shape` (nothing compiled)."""
    dropouts, connects = [], []

    def recording(x, rate, deterministic, rng):
        if not deterministic and rate > 0:
            connects.append(rate)
        return x

    key = jax.random.PRNGKey(0)
    with _recording_flax_dropout(dropouts), _jax_drop_connect_as(recording):
        jax.eval_shape(functools.partial(jmodel.init, train=True),
                       {"params": key, "dropout": key}, *map(jnp.asarray, args))
    return dropouts, connects


def _port_drop_connect_rates(model, args):
    rates = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: rates.append(mod.rate) if mod.training
                                         and mod.rate > 0 else None)
             for m in model.modules() if isinstance(m, DropConnect)]
    try:
        dropouts = _port_dropout_calls(model, args)
    finally:
        for h in hooks:
            h.remove()
    return dropouts, rates


@pytest.mark.parametrize("family", list(VARIANTS))
def test_dropout_and_drop_connect_match_jax(family):
    """One train forward at b0 on each side: the same dropouts (module and
    rate) and the same drop-connect rates in the same order; none of either
    under `train_without_dropout`."""
    jcfg, cfg = _configs(family, "b0")
    args = camera_inputs(1, h=H, w=W, seed=1)
    want = _jax_stochastic_calls(j_build_model(jcfg), args)
    model = build_model(cfg, device="cpu")
    got = _port_drop_connect_rates(model.train(), _port_args(args))
    assert got == want
    assert want[0] == ([("sceneunder", 0.5)] if family == "bev_txt" else [])
    assert len(want[1]) == 9 and want[1][0] == pytest.approx(0.2 * 2 / 16)  # b0: 9 residual blocks
    assert _port_drop_connect_rates(tsteps.train_without_dropout(model), _port_args(args)) == ([], [])


def test_drop_connect_drops_whole_samples():
    """In training each sample is kept (scaled by 1/keep) or zeroed whole,
    from torch's seeded stream; the identity in eval."""
    x = torch.ones(4000, 3, 2, 2)
    m = DropConnect(0.25).train()
    torch.manual_seed(0)
    y = m(x)
    per = y.flatten(1)
    assert bool(((per == 0).all(1) | (per == 1 / 0.75).all(1)).all())
    assert abs(float((per[:, 0] > 0).float().mean()) - 0.75) < 0.03
    torch.manual_seed(0)
    assert torch.equal(m(x), y)
    assert m.eval()(x) is x


# ---- (h) where the TXT loss sends its gradient


@pytest.mark.parametrize("family,reaches_bev", [("bev_txt", False), ("bev_txt_onlybev", True)])
def test_txt_loss_gradient_into_bevencode(family, reaches_bev):
    """The act/desc part of `multi_loss` alone, backward: BevTxt's detached
    crop gives `bevencode` no gradient (its shared encoder gets one through
    the cameras); BevTxtOnlyBev's crop is not detached."""
    _, cfg = _configs(family, "b0")
    model = tsteps.train_without_dropout(build_model(cfg, device="cpu"))
    args = _port_args(camera_inputs(1, h=H, w=W, seed=2))
    _, act, desc = model(*args)
    txt = (tl.bce_with_logits(act, torch.ones_like(act), weight=tl.ACT_WEIGHTS)
           + tl.bce_with_logits(desc, torch.ones_like(desc), weight=tl.DESC_WEIGHTS))
    txt.backward()
    norm = lambda prefix: sum(float(p.grad.norm()) for n, p in model.named_parameters()
                              if n.startswith(prefix) and p.grad is not None)
    assert (norm("bevencode.") > 0) == reaches_bev
    assert (norm("encoder.") > 0) and norm("bevpost.") > 0


# ---- (i) the one-group optimizer


def test_one_group_optimizer_matches_optax():
    """Stack A trains in one group at lr: Adam with coupled L2 and the
    global-norm clip (active at steps 0 and 2), no schedule, against optax
    over three steps. atol 1e-6: the parameters (up to 2.6 in size) move by
    about 3e-2, and float32 rounds each step's sum at 2.4e-7 there (one ulp),
    in another order of operations on each side (measured: 2.4e-7)."""
    tc = dict(lr=1e-2, weight_decay=1e-2, max_grad_norm=1.0)
    jcfg, cfg = _configs("bev_txt", "b0", **tc)
    rng = np.random.default_rng(6)
    w = {"encoder": rng.normal(size=(5, 3)).astype(np.float32),
         "predictorf1": rng.normal(size=(7,)).astype(np.float32)}
    tx = js.build_optimizer(jcfg)
    params = {k: jnp.asarray(v) for k, v in w.items()}
    opt_state = tx.init(params)
    model = torch.nn.Module()
    for k, v in w.items():
        model.register_parameter(k, torch.nn.Parameter(T(v.copy())))
    opt, sched = ts.build_optimizer(cfg, model)
    assert len(opt.param_groups) == 1 and opt.param_groups[0]["lr"] == 1e-2
    for scale in (2.0, 0.1, 5.0):
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in w.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, v in g.items():
            getattr(model, k).grad = T(v)
        torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.train.max_grad_norm)
        opt.step()
        sched.step()
    for k in w:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), params[k], atol=1e-6)
        assert np.abs(np.asarray(params[k]) - w[k]).max() > 1e-2  # it moved
    assert opt.param_groups[0]["lr"] == 1e-2


# ---- the fused Embedder, alone


def test_embedder_matches_jax():
    """conv-BN-ReLU, flatten in (C, H, W) order, linear; eval, 1e-5."""
    jm_ = JEmbedder(out_features=16)
    x = np.random.default_rng(8).normal(size=(2, 8, 22, 32)).astype(np.float32)
    v = random_variables(jm_, (jnp.asarray(x),), seed=9)
    want = np.asarray(jm_.apply(v, jnp.asarray(x)))
    m = Embedder(32, 16, (8, 22)).eval()
    p, s = v["params"], v["batch_stats"]
    with torch.no_grad():
        m.conv[0].weight.copy_(T(np.transpose(p["conv"]["conv"]["kernel"], (3, 2, 0, 1)).copy()))
        for name, src in (("weight", p["conv"]["bn"]["scale"]), ("bias", p["conv"]["bn"]["bias"]),
                          ("running_mean", s["conv"]["bn"]["mean"]),
                          ("running_var", s["conv"]["bn"]["var"])):
            getattr(m.conv[1], name).copy_(T(np.asarray(src)))
        m.fc.weight.copy_(T(np.asarray(p["fc"]["kernel"]).T.copy()))
        m.fc.bias.copy_(T(np.asarray(p["fc"]["bias"])))
        got = m(T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()))
