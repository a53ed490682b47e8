"""The port's training slice against the JAX package's, float32, on the CPU:
losses, the optimizer and schedule, one full train step of the flagship and
its eval step, at the dryrun shapes of `test_torch_model.py` (6 cameras at
32x96, a 32x32 BEV grid) with the weights carried JAX -> port by
`state_dict_from_jax`.

Dropout is off on both sides of a comparison: flax's `Dropout` is patched to
identity (the pattern of `test_reference_train_parity.py`), the port's model
goes through `train_without_dropout`. Cross-framework random streams cannot
be aligned; every other part of the step runs live. The dropouts themselves
are held to the JAX package's by place and rate, and their stream by seed
and step."""
import contextlib
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.port.torch_port import port_state_dict
from lss2_multimodal_nu_tpu.train import losses as jl, metrics as jm, state as js, steps as jsteps
from lss2_multimodal_nu_tpu_torch import config as tconfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.port import state_dict_from_jax
from lss2_multimodal_nu_tpu_torch.train import losses as tl, metrics as tm, state as ts
from lss2_multimodal_nu_tpu_torch.train import steps as tsteps
from test_torch_modules import FINAL_DIM, XB, camera_inputs, random_variables

T = torch.from_numpy
B = 2


class _IdentityDropout(fnn.Module):
    """Drop-in for flax.linen.Dropout that is always a no-op."""

    rate: float = 0.0
    deterministic: bool = True

    def __call__(self, x, deterministic=None):
        return x


@contextlib.contextmanager
def _flax_dropout_as(cls):
    orig = fnn.Dropout
    fnn.Dropout = cls
    try:
        yield
    finally:
        fnn.Dropout = orig


def _no_flax_dropout():
    return _flax_dropout_as(_IdentityDropout)


def _recording_flax_dropout(calls):
    """Identity dropout that appends (top-level module, rate) to `calls`
    for each call that would drop in training."""

    class _Recording(_IdentityDropout):
        def __call__(self, x, deterministic=None):
            if not self.deterministic:
                calls.append((self.scope.path[0], self.rate))
            return x

    return _flax_dropout_as(_Recording)


def test_train_config_defaults_match_jax():
    """Same fields and defaults, minus the TPU-only and logging knobs."""
    jd = {f.name: getattr(jconfig.TrainConfig(), f.name)
          for f in dataclasses.fields(jconfig.TrainConfig)}
    td = {f.name: getattr(tconfig.TrainConfig(), f.name)
          for f in dataclasses.fields(tconfig.TrainConfig)}
    for k in ("dropout_rng_impl", "watch_gradients", "log_every"):
        jd.pop(k)
    assert jd == td
    assert tconfig.Config().train == tconfig.TrainConfig()


# ---- (a) losses, against the JAX functions on seeded logits, atol 1e-6


def _loss_inputs(seed=0, b=2, x=6, c=4):
    rng = np.random.default_rng(seed)
    bev = (rng.normal(size=(b, x, x, c)) * 3).astype(np.float32)  # JAX NHWC
    labels = rng.integers(0, c, size=(b, x, x)).astype(np.int32)
    act = (rng.normal(size=(b, 4)) * 3).astype(np.float32)
    desc = (rng.normal(size=(b, 8)) * 3).astype(np.float32)
    act_t = (rng.random((b, 4)) < 0.4).astype(np.float32)
    desc_t = (rng.random((b, 8)) < 0.4).astype(np.float32)
    return bev, labels, act, desc, act_t, desc_t


def _nchw(a):
    return T(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


LOSSES = {
    "weighted_cross_entropy": (
        lambda bev, lab, *_: jl.weighted_cross_entropy(bev, lab, jl.BEV_CLASS_WEIGHTS),
        lambda bev, lab, *_: tl.weighted_cross_entropy(bev, lab, tl.BEV_CLASS_WEIGHTS)),
    "bce_weight": (
        lambda bev, lab, act, desc, at, dt: jl.bce_with_logits(act, at, weight=jl.ACT_WEIGHTS),
        lambda bev, lab, act, desc, at, dt: tl.bce_with_logits(act, at, weight=jl.ACT_WEIGHTS)),
    "bce_pos_weight": (
        lambda bev, lab, act, desc, at, dt: jl.bce_with_logits(
            desc, dt, pos_weight=jl.DESC_POS_WEIGHT_V2),
        lambda bev, lab, act, desc, at, dt: tl.bce_with_logits(
            desc, dt, pos_weight=tl.DESC_POS_WEIGHT_V2)),
    "multi_task_loss": (
        lambda *a: jl.multi_task_loss(a[0], a[2], a[3], a[1], a[4], a[5]),
        lambda *a: tl.multi_task_loss(a[0], a[2], a[3], a[1], a[4], a[5])),
    "cross_entropy_ignore": (
        lambda bev, lab, *_: jl.cross_entropy_ignore(bev, jnp.where(lab == 1, 255, lab)),
        lambda bev, lab, *_: tl.cross_entropy_ignore(bev, torch.where(lab == 1, 255, lab))),
    "cross_entropy_all_ignored": (
        lambda bev, lab, *_: jl.cross_entropy_ignore(bev, jnp.full_like(lab, 255)),
        lambda bev, lab, *_: tl.cross_entropy_ignore(bev, torch.full_like(lab, 255))),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(name):
    """NHWC logits on the JAX side, NCHW on the port's; atol 1e-6."""
    bev, labels, act, desc, act_t, desc_t = _loss_inputs(seed=len(name))
    jfn, tfn = LOSSES[name]
    want = jfn(*map(jnp.asarray, (bev, labels, act, desc, act_t, desc_t)))
    got = tfn(_nchw(bev), T(labels).long(), *map(T, (act, desc, act_t, desc_t)))
    if isinstance(want, tuple):  # (total, components)
        want = {"total": want[0], **want[1]}
        got = {"total": got[0], **got[1]}
        assert got.keys() == want.keys()
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    else:
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6


def test_losses_run_in_float32_on_bf16_logits():
    bev, labels, *_ = _loss_inputs()
    got = tl.weighted_cross_entropy(_nchw(bev).bfloat16(), T(labels), tl.BEV_CLASS_WEIGHTS)
    want = tl.weighted_cross_entropy(_nchw(bev).bfloat16().float(), T(labels), tl.BEV_CLASS_WEIGHTS)
    assert got.dtype == torch.float32 and float(got) == float(want)


# ---- (b) the optimizer alone


def _tiny_cfgs(**train):
    tc = dict(lr=1e-2, weight_decay=1e-2, max_grad_norm=1.0, num_epochs=4, warmup_epochs=2,
              min_lr=1e-6, use_schedule=True, backbone_lr_mult=0.1)
    tc.update(train)
    jcfg = jconfig.Config(model=jconfig.ModelConfig(family="vovnet_transformer"),
                          train=jconfig.TrainConfig(**tc))
    cfg = tconfig.Config(model=tconfig.ModelConfig(family="vovnet_transformer"),
                         train=tconfig.TrainConfig(**tc))
    return jcfg, cfg


class _TwoGroups(torch.nn.Module):
    """One module of each parameter group."""

    def __init__(self, w_low, w_high):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.w = torch.nn.Parameter(T(w_low.copy()))
        self.unified_predictor = torch.nn.Module()
        self.unified_predictor.w = torch.nn.Parameter(T(w_high.copy()))


def test_optimizer_matches_optax():
    """Three steps with the same params and the same gradients: Adam with
    coupled L2, the 0.1x backbone group, the warmup-cosine schedule (step
    0's rate is 0) and the global-norm clip (active at steps 0 and 2). atol
    1e-7: the only difference is torch's clip denominator, norm + 1e-6
    where optax divides by the norm, a relative 1e-6 change of the clipped
    gradient that Adam's normalisation all but cancels."""
    jcfg, cfg = _tiny_cfgs()
    rng = np.random.default_rng(0)
    w_low, w_high = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)
    tx = js.build_optimizer(jcfg, steps_per_epoch=1)
    params = {"backbone": {"w": jnp.asarray(w_low)}, "unified_predictor": {"w": jnp.asarray(w_high)}}
    opt_state = tx.init(params)
    model = _TwoGroups(w_low, w_high)
    opt, sched = ts.build_optimizer(cfg, model, steps_per_epoch=1)
    assert [g["lr"] for g in opt.param_groups] == [0.0, 0.0]  # warmup starts at 0
    for scale in (2.0, 0.1, 5.0):
        g_low = (rng.normal(size=(5, 3)) * scale).astype(np.float32)
        g_high = (rng.normal(size=(7,)) * scale).astype(np.float32)
        grads = {"backbone": {"w": jnp.asarray(g_low)}, "unified_predictor": {"w": jnp.asarray(g_high)}}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        model.backbone.w.grad, model.unified_predictor.w.grad = T(g_low), T(g_high)
        torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.train.max_grad_norm)
        opt.step()
        sched.step()
    np.testing.assert_allclose(model.backbone.w.detach().numpy(), params["backbone"]["w"], atol=1e-7)
    np.testing.assert_allclose(model.unified_predictor.w.detach().numpy(),
                               params["unified_predictor"]["w"], atol=1e-7)
    assert np.abs(params["unified_predictor"]["w"] - w_high).max() > 1e-3  # it moved


def test_schedule_matches_jax():
    """Warmup, then the cosine with its multiplier floor (min_lr 0.3 here,
    so the floor shows); and a constant rate without the schedule."""
    want = js.warmup_cosine_schedule(1e-3, 5, 20, 0.3)
    mult = ts.warmup_cosine_multiplier(5, 20, 0.3)
    steps = np.arange(25)
    np.testing.assert_allclose([1e-3 * mult(int(s)) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-6, atol=1e-12)
    _, cfg = _tiny_cfgs(use_schedule=False)
    opt, sched = ts.build_optimizer(cfg, _TwoGroups(np.zeros(1, np.float32), np.zeros(1, np.float32)))
    opt.step()
    sched.step()
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([1e-3, 1e-2])
    with pytest.raises(ValueError, match="steps_per_epoch"):
        ts.build_optimizer(_tiny_cfgs()[1], _TwoGroups(np.zeros(1, np.float32), np.zeros(1, np.float32)))


def test_parameter_groups_follow_the_top_module():
    cfg = tconfig.Config(model=tconfig.ModelConfig(family="vovnet_transformer"),
                         grid=tconfig.GridConfig(xbound=XB, ybound=XB),
                         aug=tconfig.AugConfig(final_dim=FINAL_DIM))
    model = build_model(cfg, device="cpu")
    opt, _ = ts.build_optimizer(cfg, model)
    low = {id(p) for p in opt.param_groups[0]["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in low) == (name.split(".")[0] in js.PRETRAINED_PREFIXES), name
    assert sum(len(g["params"]) for g in opt.param_groups) == len(list(model.parameters()))


# ---- (c) one train step and (d) the eval step of the flagship


@pytest.fixture(scope="module")
def flagship():
    """JAX model and variables, the port's model with the same weights, one
    batch, and the configs: V3 at B=2, 32x32 BEV, lr 1e-4, wd 1e-8. The
    clip is out of reach (max_grad_norm 1e6), so the gradients left on the
    port's parameters are the raw ones; the clip is held to optax's in
    test_optimizer_matches_optax."""
    train = dict(lr=1e-4, weight_decay=1e-8, max_grad_norm=1e6)
    jcfg = jconfig.Config(grid=jconfig.GridConfig(xbound=XB, ybound=XB),
                          aug=jconfig.AugConfig(final_dim=FINAL_DIM),
                          model=jconfig.ModelConfig(family="vovnet_transformer"),
                          train=jconfig.TrainConfig(dropout_rng_impl="threefry", **train))
    cfg = tconfig.Config(grid=tconfig.GridConfig(xbound=XB, ybound=XB),
                         aug=tconfig.AugConfig(final_dim=FINAL_DIM),
                         model=tconfig.ModelConfig(family="vovnet_transformer"),
                         train=tconfig.TrainConfig(**train))
    args = camera_inputs(B, seed=9)
    jmodel = j_build_model(jcfg)
    variables = random_variables(jmodel, args, seed=13)
    rng = np.random.default_rng(21)
    labels = dict(binimg=rng.integers(0, 4, size=(B, 32, 32)).astype(np.int32),
                  act=(rng.random((B, 4)) < 0.4).astype(np.float32),
                  desc=(rng.random((B, 8)) < 0.4).astype(np.float32))
    jbatch = dict(zip(jsteps.MODEL_INPUTS, map(jnp.asarray, args)),
                  **{k: jnp.asarray(v) for k, v in labels.items()})
    tbatch = dict(zip(tsteps.MODEL_INPUTS, [T(np.ascontiguousarray(args[0].transpose(0, 1, 4, 2, 3)))]
                      + [T(a) for a in args[1:]]),
                  binimg=T(labels["binimg"]).long(), act=T(labels["act"]), desc=T(labels["desc"]))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    return jcfg, cfg, jmodel, variables, jbatch, tbatch, model


def _fresh_model(cfg, variables):
    """The port's flagship with the JAX variables' weights."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    return model


def _grad_capture():
    """An optax transform that changes nothing and keeps the gradients it is
    given in its state, so make_train_step itself hands them back."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           {"grads": grads}))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def stepped(flagship):
    """One train step on each side. JAX: `make_train_step` with the grad
    capture for its optimizer. Port: `train_step`, with the n of every
    batch norm (elements per channel of its input) recorded."""
    jcfg, cfg, jmodel, variables, jbatch, tbatch, model = flagship
    tx = _grad_capture()
    state = js.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    with _no_flax_dropout():
        new_state, jmetrics = jsteps.make_train_step(jcfg, jmodel)(state, jbatch, jax.random.PRNGKey(0))
    tsteps.train_without_dropout(model)
    opt, sched = ts.build_optimizer(cfg, model)
    counts = {}
    bn = torch.nn.functional.batch_norm

    def counting_bn(x, running_mean, running_var, *a, **k):
        counts[running_var.data_ptr()] = x.numel() // x.shape[1]
        return bn(x, running_mean, running_var, *a, **k)

    stats0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    torch.nn.functional.batch_norm = counting_bn
    try:
        metrics = tsteps.train_step(model, opt, sched, tbatch, 0)
    finally:
        torch.nn.functional.batch_norm = bn
    n_of = {name: counts[buf.data_ptr()] for name, buf in model.named_buffers()
            if name.endswith("running_var")}
    return jmetrics, new_state, metrics, model, stats0, n_of


def test_train_step_loss_and_grad_norm_match_jax(stepped):
    """Loss and its components to 1e-4 relative, grad_norm to 2e-3 relative:
    ten times the differences measured at these inputs (1.2e-5 and 2.3e-4),
    which come from the forward's float32 round-off in other orders."""
    jmetrics, _, metrics, *_ = stepped
    assert set(metrics) == {"loss", "bev", "action", "desc", "grad_norm"}
    for k in ("loss", "bev", "action", "desc"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-4), k
    assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=2e-3)


def _port_grads(model):
    """The port's gradients in the JAX layout, through the JAX package's
    porter."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        sd[name] = p.grad.numpy()
    grads, _, missing = port_state_dict("vovnet_transformer", sd)
    assert not missing
    return _flat(grads)


def _compare_grads(got, want, label):
    """Per-leaf check of `test_train_step_grads_match_jax`; returns the
    norm-relative differences of the leaves that are not zero."""
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    zero = [k for k in want if np.abs(want[k]).max() <= 1e-4 * top]
    assert any("compress" in k for k in zero) and len(zero) < 20, zero
    rel = {}
    for k in want:
        if k in zero:
            assert np.abs(got[k]).max() <= 1e-3 * top, k
        else:
            assert np.abs(got[k]).max() > 0, k
            rel[k] = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    print(f"{label}: per-leaf norm-relative difference worst {worst[0][1]:.3g} "
          f"({worst[0][0]}), median {np.median(list(rel.values())):.3g}")
    assert worst[0][1] <= 0.25 and np.median(list(rel.values())) <= 0.06, worst
    return rel


def test_train_step_grads_match_jax(stepped):
    """Every leaf's gradient, carried back to the JAX layout through the JAX
    package's porter.

    Leaves whose JAX gradient is below 1e-4 of the model's largest |grad|
    are those zero in exact arithmetic (a conv bias before a train-mode
    batch norm, which subtracts the batch mean; a key-projection bias under
    a softmax over keys); on the port's side they must stay below 1e-3 of
    it. Every other leaf must be non-zero on the port's side and agree
    within 0.25 in norm relative to JAX's (the median leaf within 0.06). At
    random weights and the dryrun's small maps (c4 is 1x3) the float32
    gradient is chaotic: one ReLU or bilinear cell that flips under
    round-off moves a layer's gradient by a visible share, as
    `test_train_step_grads_chaos_control` shows on the port alone (worst
    leaf about 0.06, median about 0.02, as port against JAX); the bounds
    leave room for another machine's round-off. A gradient cut off or
    scaled by a wrong factor is off by 1 or more."""
    _, new_state, _, model, _, _ = stepped
    _compare_grads(_port_grads(model), _flat(new_state.opt_state["grads"]), "port vs JAX")


def test_train_step_grads_chaos_control(flagship):
    """The yardstick of the tolerances above: the port against itself, one
    train step from the same weights with every parameter moved by 1e-7 of
    its mean |value|, meets the same per-leaf bounds, and its differences
    are of the size of the port-against-JAX ones (printed with -s)."""
    _, cfg, _, variables, _, tbatch, _ = flagship
    grads = []
    for eps in (0.0, 1e-7):
        model = _fresh_model(cfg, variables)
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(eps * p.abs().mean() * torch.randn(p.shape, generator=gen))
        tsteps.train_without_dropout(model)
        opt, sched = ts.build_optimizer(cfg, model)
        tsteps.train_step(model, opt, sched, tbatch, 0)
        grads.append(_port_grads(model))
    _compare_grads(grads[1], grads[0], "port vs port moved by 1e-7")


def test_train_step_batch_norm_statistics_match_jax(stepped):
    """running_mean as JAX's mean; running_var against JAX's var with its
    biased batch variance brought to torch's unbiased one by n/(n-1), n the
    elements per channel of the layer's input (ROADMAP.md fault e). Both to
    2e-4 of the layer's largest value, ten times the worst difference
    measured here (1.7e-5, the forward's round-off)."""
    _, new_state, _, model, stats0, n_of = stepped
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd0 = dict(sd, **{k: v.numpy() for k, v in stats0.items()})
    _, bs_new, _ = port_state_dict("vovnet_transformer", sd)
    _, bs_old, _ = port_state_dict("vovnet_transformer", sd0)
    _, bs_n, _ = port_state_dict("vovnet_transformer",
                                 dict(sd, **{k: np.full_like(sd[k], n) for k, n in n_of.items()}))
    got, old, jax_new, ns = (_flat(t) for t in (bs_new, bs_old, new_state.batch_stats, bs_n))
    assert got.keys() == jax_new.keys() and len(got) == 2 * len(n_of)
    assert min(ns[k].min() for k in ns if k.endswith("['var']")) == B * 6  # ASPP's pool: B*N
    for k in jax_new:
        if k.endswith("['var']"):
            n = ns[k]
            want = 0.9 * old[k] + (jax_new[k] - 0.9 * old[k]) * n / (n - 1)
        else:
            want = jax_new[k]
        assert np.abs(got[k] - old[k]).max() > 0, k  # the statistics moved
        np.testing.assert_allclose(got[k], want, atol=2e-4 * np.abs(want).max(), err_msg=k)


def stage4_statistics_match_jax(model, fresh, jax_batch_stats, imgs, **porter_kw):
    """Stage 4 of the VoVNet trunk, after one train step: its batch-norm
    running statistics against JAX's, by `test_train_step_batch_norm_statistics_match_jax`'s
    rule (running_var from JAX's biased variance by n/(n-1); 2e-4 of the
    layer's largest value). `fresh` holds the statistics before the step;
    n, the elements per channel of every stage-4 batch norm's input, is
    B*N times stage 4's output area."""
    with torch.no_grad():
        c4 = fresh.backbone.backbone.eval()(imgs.reshape(-1, *imgs.shape[2:]), True)["c4"]
    n = c4.numel() // c4.shape[1]
    stats = [port_state_dict("vovnet_transformer", {k: v.detach().numpy() for k, v in
                                                    m.state_dict().items()}, **porter_kw)[1]
             for m in (model, fresh)]
    got, old, jax_new = (_flat(t) for t in (*stats, jax_batch_stats))
    keys = [k for k in jax_new if "['stage4_" in k]
    assert keys and all(k in got for k in keys)
    for k in keys:
        want = jax_new[k]
        if k.endswith("['var']"):
            want = 0.9 * old[k] + (jax_new[k] - 0.9 * old[k]) * n / (n - 1)
        assert np.abs(jax_new[k] - old[k]).max() > 0, k  # JAX's moved
        assert np.abs(got[k] - old[k]).max() > 0, k  # and the port's
        np.testing.assert_allclose(got[k], want, atol=2e-4 * np.abs(want).max(), err_msg=k)
    return len(keys)


def test_eval_step_matches_jax(flagship):
    """`eval_step` against `make_eval_step`: the loss to 1e-5 relative; the
    confusion matrix and the action/description predictions equal, except
    where JAX's own margin is within the forward's agreement (2e-3 on the
    BEV logits, 1e-3 on action/desc, as in test_torch_model.py)."""
    jcfg, cfg, jmodel, variables, jbatch, tbatch, _ = flagship
    model = _fresh_model(cfg, variables)
    conf0 = np.arange(16, dtype=np.int32).reshape(4, 4)
    want = jsteps.make_eval_step(jcfg, jmodel)(variables["params"], variables["batch_stats"],
                                               jbatch, jnp.asarray(conf0))
    got = tsteps.eval_step(model, tbatch, T(conf0).long())
    assert got["bsize"] == B == int(want["bsize"])
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    out = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, *(jbatch[k] for k in jsteps.MODEL_INPUTS))
    top2 = np.sort(np.asarray(out[0]), axis=-1)[..., -2:]
    close = int((top2[..., 1] - top2[..., 0] < 2e-3).sum())
    diff = np.abs(got["confmat"].numpy() - np.asarray(want["confmat"])).sum()
    assert diff <= 2 * close
    for k, logits in (("act_pred", out[1]), ("desc_pred", out[2])):
        flip = got[k].numpy() != np.asarray(want[k])
        assert not (flip & (np.abs(np.asarray(logits)) > 1e-3)).any(), k
    with pytest.raises(ValueError, match="eval mode"):
        tsteps.eval_step(model.train(), tbatch, T(conf0).long())


def test_confusion_matrix_and_f1_match_jax():
    rng = np.random.default_rng(3)
    labels = rng.integers(-1, 5, size=(2, 9, 9)).astype(np.int32)  # -1, 4: not counted
    preds = rng.integers(0, 4, size=(2, 9, 9)).astype(np.int32)
    mat0 = rng.integers(0, 5, size=(4, 4)).astype(np.int32)
    want = np.asarray(jm.confusion_matrix_update(jnp.asarray(mat0), jnp.asarray(labels),
                                                 jnp.asarray(preds), 4))
    got = tm.confusion_matrix_update(T(mat0), T(labels), T(preds), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tm.format_confusion(want) == jm.format_confusion(want)
    t = (rng.random((20, 8)) < 0.4).astype(np.int32)
    p = (rng.random((20, 8)) < 0.4).astype(np.int32)
    per_t, all_t, mean_t = tm.per_class_and_macro_f1(t, p)
    per_j, all_j, mean_j = jm.per_class_and_macro_f1(t, p)
    np.testing.assert_array_equal(per_t, per_j)
    assert (all_t, mean_t) == (all_j, mean_j)


def test_other_families_have_no_loss_yet():
    """Every family of the JAX package has its loss now (the pretrain's is
    held to JAX in `test_torch_pretrain.py`); a family the JAX steps do not
    know is refused."""
    cfg = tconfig.Config(model=tconfig.ModelConfig(family="no_such_family"))
    with pytest.raises(ValueError, match="unknown model family"):
        tsteps.compute_loss(cfg, None, {})


def test_train_step_refuses_an_eval_model(flagship):
    *_, tbatch, model = flagship
    opt, sched = ts.build_optimizer(flagship[1], model)
    with pytest.raises(ValueError, match="training mode"):
        tsteps.train_step(model.eval(), opt, sched, tbatch, 0)


# ---- dropout: places, rates and the stream


def _port_dropout_calls(model, args):
    """(top-level module, rate) of each dropout that one forward of `model`
    draws, in call order: nn.Dropout and the attention modules' dropout
    both go through F.dropout."""
    calls, where = [], [None]
    orig = torch.nn.functional.dropout

    def recording(x, p=0.5, training=True, inplace=False):
        if training:
            calls.append((where[0], p))
        return orig(x, p, training, inplace)

    hooks = [m.register_forward_pre_hook(lambda mod, a, n=n: where.__setitem__(0, n))
             for n, m in model.named_children()]
    torch.nn.functional.dropout = recording
    try:
        with torch.no_grad():
            model(*args)
    finally:
        torch.nn.functional.dropout = orig
        for h in hooks:
            h.remove()
    return calls


def test_dropout_places_and_rates_match_jax(flagship):
    """One train forward on each side: the same dropouts in the same order,
    with the same rates, in the same top-level modules. That is 0.1 three
    times in the BEV encoder layer, 0.5 in ASPP, 0.1 on the camera
    attention and in its FFN, 0.1 on the BEV-camera attention and 0.1 in
    the predictor."""
    _, cfg, jmodel, variables, jbatch, tbatch, _ = flagship
    want = []
    with _recording_flax_dropout(want):
        jax.eval_shape(lambda: jmodel.apply(variables, *(jbatch[k] for k in jsteps.MODEL_INPUTS),
                                            train=True, mutable=["batch_stats"]))
    got = _port_dropout_calls(_fresh_model(cfg, variables).train(),
                              [tbatch[k] for k in tsteps.MODEL_INPUTS])
    assert got == want
    assert want == [("bev_encoder", 0.1)] * 3 + [("sceneunder", 0.5)] + [
        ("camera_transformer", 0.1)] * 2 + [("bev_fusion", 0.1), ("unified_predictor", 0.1)]
    assert _port_dropout_calls(tsteps.train_without_dropout(_fresh_model(cfg, variables)),
                               [tbatch[k] for k in tsteps.MODEL_INPUTS]) == []


def test_dropout_stream_follows_seed_and_step(flagship):
    """`train_step` draws its masks from (cfg.train.seed, step): from the
    same weights, the same step gives the same loss, another step or seed
    another loss; with dropout off the step does not matter."""
    _, cfg, _, variables, _, tbatch, _ = flagship

    def loss(step, seed=0, dropout=True):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
        model = _fresh_model(c, variables)
        model.train() if dropout else tsteps.train_without_dropout(model)
        opt, sched = ts.build_optimizer(c, model)
        return float(tsteps.train_step(model, opt, sched, tbatch, step)["loss"])

    first = loss(3)
    assert loss(3) == first
    assert loss(4) != first and loss(3, seed=1) != first
    assert loss(3, dropout=False) == loss(4, dropout=False) != first
