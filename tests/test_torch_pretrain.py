"""The port's stage-1 model, `VoVNetPreTrain`, and the original repo's
from-scratch `VoVNetSimple`, against the JAX package on the CPU, float32,
at the dryrun shapes of `test_torch_model.py` (6 cameras at 32x96, a 32x32
BEV grid), with the weights carried JAX -> port by `state_dict_from_jax`;
and ROADMAP fault 7 (at LSS v1 nothing reads stage 4: it runs only in
training, without autograd, for its batch-norm statistics).

Tolerances are those the other port tests use for the same quantities:
the BEV logits 2e-3 (`test_torch_model.py`); the train step's loss 1e-4
relative, grad_norm 2e-3 relative and each gradient by
`test_torch_train.py::_compare_grads`; the eval step's loss 1e-5 relative
and its confusion matrix equal up to pixels whose top two logits are
within 2e-3 (`test_torch_train.py::test_eval_step_matches_jax`); the
optimizer 1e-7 against optax (`test_torch_train.py::test_optimizer_matches_optax`);
a bare trunk 1e-4 of its largest activation (`test_torch_modules.py`);
batch-norm running statistics 2e-4 of their largest value
(`test_torch_train.py::test_train_step_batch_norm_statistics_match_jax`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.nn.vovnet import VoVNetSimple as JVoVNetSimple
from lss2_multimodal_nu_tpu.port.torch_port import Porter, add_vovnet_scratch, port_state_dict
from lss2_multimodal_nu_tpu.train import losses as jl, state as js, steps as jsteps
from lss2_multimodal_nu_tpu_torch import config as tconfig
from lss2_multimodal_nu_tpu_torch.models.factory import FAMILIES, build_model
from lss2_multimodal_nu_tpu_torch.models.vovnet_pretrain import PRETRAIN_COMPONENTS
from lss2_multimodal_nu_tpu_torch.nn.vovnet import VoVNetSimple
from lss2_multimodal_nu_tpu_torch.port import state_dict_from_jax
from lss2_multimodal_nu_tpu_torch.train import state as ts, steps as tsteps
from test_torch_modules import FINAL_DIM, XB, camera_inputs, random_variables
from test_torch_train import (_compare_grads, _flat, _grad_capture, _no_flax_dropout,
                              stage4_statistics_match_jax)

T = torch.from_numpy
B = 2


def _configs(family, lss_version, **train):
    kw = dict(family=family, lss_version=lss_version)
    jcfg = jconfig.Config(grid=jconfig.GridConfig(xbound=XB, ybound=XB),
                          aug=jconfig.AugConfig(final_dim=FINAL_DIM),
                          model=jconfig.ModelConfig(**kw),
                          train=jconfig.TrainConfig(dropout_rng_impl="threefry", **train))
    cfg = tconfig.Config(grid=tconfig.GridConfig(xbound=XB, ybound=XB),
                         aug=tconfig.AugConfig(final_dim=FINAL_DIM),
                         model=tconfig.ModelConfig(**kw), train=tconfig.TrainConfig(**train))
    return jcfg, cfg


def _labels(seed):
    """BEV labels with about a fifth of the pixels at the ignore index 255."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 4, size=(B, 32, 32))
    return np.where(rng.random((B, 32, 32)) < 0.2, 255, lab).astype(np.int32)


def _port_batch(args, binimg):
    imgs = T(np.ascontiguousarray(args[0].transpose(0, 1, 4, 2, 3)))
    return dict(zip(tsteps.MODEL_INPUTS, [imgs] + [T(a) for a in args[1:]]),
                binimg=T(binimg).long())


@functools.lru_cache(maxsize=None)
def _setup(v):
    """The pretrain model at LSS version v, B=2, lr 1e-4, wd 1e-8 and the
    clip out of reach (max_grad_norm 1e6), so the gradients left on the
    port's parameters are the raw ones: (version, JAX config and model,
    variables, JAX batch, JAX eval logits (NCHW), port config, port model,
    port batch). Made once per version for the module's tests, which do not
    change it."""
    jcfg, cfg = _configs("vovnet_pretrain", v, lr=1e-4, weight_decay=1e-8, max_grad_norm=1e6)
    args = camera_inputs(B, seed=41)
    jmodel = j_build_model(jcfg)
    variables = random_variables(jmodel, args, seed=43)
    binimg = _labels(45)
    jbatch = dict(zip(jsteps.MODEL_INPUTS, map(jnp.asarray, args)), binimg=jnp.asarray(binimg))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                              family="vovnet_pretrain", lss_version=v))
    jout = jax.jit(lambda var, *a: jmodel.apply(var, *a, train=False))(
        variables, *(jbatch[k] for k in jsteps.MODEL_INPUTS))
    jout = np.moveaxis(np.asarray(jout), 3, 1)
    return v, jcfg, jmodel, variables, jbatch, jout, cfg, model, _port_batch(args, binimg)


@pytest.fixture(scope="module", params=["v1", "v2"])
def pretrain(request):
    """`_setup` at LSS v1 (the CLI's pretrain-v2 default) and v2."""
    return _setup(request.param)


@pytest.fixture(scope="module")
def pretrain_v1():
    """`_setup` at v1, where the train and eval steps are compared."""
    return _setup("v1")


def _fresh(cfg, variables, v):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                              family="vovnet_pretrain", lss_version=v))
    return model


def test_build_model_builds_every_family():
    assert set(FAMILIES) == {"lss", "bev_txt", "bev_txt_onlybev", "vovnet_transformer",
                             "vovnet_pretrain"}
    _, cfg = _configs("vovnet_pretrain", "v1")
    model = build_model(cfg, device="cpu")
    assert [n for n, _ in model.named_children()] == list(PRETRAIN_COMPONENTS)


def test_weights_round_trip(pretrain):
    """JAX tree -> state_dict_from_jax -> the JAX package's flagship porter
    (which has no pretrain rule; the pretrain's four components are the
    flagship's) -> the same tree, bit for bit; the port's model takes
    exactly the keys that state_dict_from_jax makes."""
    v, _, _, variables, _, _, cfg, model, _ = pretrain
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             family="vovnet_pretrain", lss_version=v)
    assert set(sd) == set(model.state_dict())
    params, batch_stats, _ = port_state_dict("vovnet_transformer",
                                             {k: t.numpy() for k, t in sd.items()},
                                             strict=False, lss_version=v)
    for got, want in ((params, variables["params"]), (batch_stats, variables["batch_stats"])):
        got, want = _flat(got), _flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_forward_matches_jax(pretrain):
    """The eval forward: the BEV logits alone, 2e-3."""
    *_, want, _, model, tbatch = pretrain
    with torch.inference_mode():
        got = model(*(tbatch[k] for k in tsteps.MODEL_INPUTS))
    assert got.shape == (B, 4, 32, 32) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


@pytest.fixture(scope="module")
def stepped(pretrain_v1):
    """One train step on each side at LSS v1, dropout off on both: JAX
    `make_train_step` with the grad capture for its optimizer, the port's
    `train_step`."""
    v, jcfg, jmodel, variables, jbatch, _, cfg, _, tbatch = pretrain_v1
    tx = _grad_capture()
    state = js.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    with _no_flax_dropout():
        new_state, jmetrics = jsteps.make_train_step(jcfg, jmodel)(state, jbatch,
                                                                   jax.random.PRNGKey(0))
    model = tsteps.train_without_dropout(_fresh(cfg, variables, v))
    opt, sched = ts.build_optimizer(cfg, model)
    metrics = tsteps.train_step(model, opt, sched, tbatch, 0)
    return jmetrics, new_state, metrics, model


def _port_grads(model, v):
    """The port's gradients in the JAX layout; stage 4 of the trunk, which
    nothing reads at v1, as zeros (its gradient is None)."""
    sd = {k: t.detach().numpy() for k, t in model.state_dict().items()}
    for name, p in model.named_parameters():
        sd[name] = np.zeros_like(sd[name]) if p.grad is None else p.grad.numpy()
    grads, _, _ = port_state_dict("vovnet_transformer", sd, strict=False, lss_version=v)
    return _flat(grads)


def test_train_step_matches_jax(stepped):
    """Loss (cross entropy over the labels not at 255) to 1e-4 relative,
    grad_norm to 2e-3 relative, and every gradient leaf by
    `_compare_grads`. Stage 4's leaves are None on the port (never
    computed, fault 7's repair) and exactly 0 in JAX; they are held to that
    and left out of the per-leaf limits."""
    jmetrics, new_state, metrics, model = stepped
    assert set(metrics) == {"loss", "grad_norm"}
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=2e-3)
    unused = {n for n, p in model.named_parameters() if p.grad is None}
    assert unused and all(n.startswith("backbone.backbone.stages.3.") for n in unused)
    got, want = _port_grads(model, "v1"), _flat(new_state.opt_state["grads"])
    for k in [k for k in want if "['stage4_" in k]:
        assert not got[k].any() and not want[k].any(), k
        del got[k], want[k]
    _compare_grads(got, want, "pretrain, port vs JAX")


def test_stage_4_batch_norm_statistics_match_jax(stepped, pretrain_v1):
    """ROADMAP fault 7: at LSS v1 the train step still updates stage 4's
    batch-norm running statistics, as JAX's does, though nothing reads the
    stage (`test_torch_train.py::stage4_statistics_match_jax`)."""
    v, _, _, variables, _, _, cfg, _, tbatch = pretrain_v1
    _, new_state, _, model = stepped
    assert stage4_statistics_match_jax(model, _fresh(cfg, variables, v), new_state.batch_stats,
                                       tbatch["imgs"], strict=False, lss_version=v) > 0


def test_loss_ignores_255(pretrain):
    """The pretrain's loss is the unweighted cross entropy over the pixels
    not at 255 (JAX `train/steps.py:44-46`): the JAX function on the port's
    own logits, 1e-6."""
    *_, cfg, model, tbatch = pretrain
    with torch.inference_mode():
        out = model(*(tbatch[k] for k in tsteps.MODEL_INPUTS))
        loss, metrics = tsteps.compute_loss(cfg, out, tbatch)
    want = jl.cross_entropy_ignore(jnp.asarray(np.moveaxis(out.numpy(), 1, 3)),
                                   jnp.asarray(tbatch["binimg"].numpy()))
    assert set(metrics) == {"loss"} and (tbatch["binimg"] == 255).any()
    assert float(loss) == pytest.approx(float(want), abs=1e-6)


def test_eval_step_matches_jax(pretrain_v1):
    """`eval_step` against `make_eval_step`, the pretrain single-output, at
    LSS v1: the loss to 1e-5 relative, the confusion matrix equal up to
    pixels whose top two JAX logits are within 2e-3, no act/desc
    predictions."""
    v, jcfg, jmodel, variables, jbatch, jout, cfg, _, tbatch = pretrain_v1
    model = _fresh(cfg, variables, v)
    conf0 = np.arange(16, dtype=np.int32).reshape(4, 4)
    want = jsteps.make_eval_step(jcfg, jmodel)(variables["params"], variables["batch_stats"],
                                               jbatch, jnp.asarray(conf0))
    got = tsteps.eval_step(model, tbatch, T(conf0).long())
    assert set(got) == {"confmat", "loss", "bsize"} and got["bsize"] == B
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    top2 = np.sort(jout, axis=1)[:, -2:]
    close = int((top2[:, 1] - top2[:, 0] < 2e-3).sum())
    diff = np.abs(got["confmat"].numpy() - np.asarray(want["confmat"])).sum()
    assert diff <= 2 * close
    # the ignored pixels are not counted
    assert int(got["confmat"].sum() - conf0.sum()) == int((tbatch["binimg"] != 255).sum())


def test_optimizer_matches_optax():
    """pretrain-v2's optimizer (`cli.py:50` puts the family under the
    schedule; clip 5.0, `add_common`'s default): one group at the full rate,
    Adam with coupled L2, the warmup-cosine schedule per step (step 0's rate
    is 0) and the global-norm clip (active at steps 0 and 2), against the
    JAX package's `build_optimizer` over three steps, atol 1e-7."""
    tc = dict(lr=1e-2, weight_decay=1e-2, max_grad_norm=5.0, num_epochs=4, warmup_epochs=2,
              min_lr=1e-6, use_schedule=True)
    jcfg, cfg = _configs("vovnet_pretrain", "v1", **tc)
    rng = np.random.default_rng(8)
    w = {"backbone": rng.normal(size=(5, 3)).astype(np.float32),
         "bev_encoder": rng.normal(size=(7,)).astype(np.float32)}
    tx = js.build_optimizer(jcfg, steps_per_epoch=1)
    params = {k: {"w": jnp.asarray(a)} for k, a in w.items()}
    opt_state = tx.init(params)
    model = torch.nn.Module()
    for k, a in w.items():
        setattr(model, k, torch.nn.Module())
        getattr(model, k).w = torch.nn.Parameter(T(a.copy()))
    opt, sched = ts.build_optimizer(cfg, model, steps_per_epoch=1)
    assert len(opt.param_groups) == 1 and opt.param_groups[0]["lr"] == 0.0
    rates = []
    for scale in (20.0, 0.1, 50.0):
        g = {k: (rng.normal(size=a.shape) * scale).astype(np.float32) for k, a in w.items()}
        updates, opt_state = tx.update({k: {"w": jnp.asarray(a)} for k, a in g.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, a in g.items():
            getattr(model, k).w.grad = T(a)
        norm = torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.train.max_grad_norm)
        rates.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
        assert (float(norm) > 5.0) == (scale > 1.0)
    assert rates == pytest.approx([0.0, 5e-3, 1e-2])
    for k in w:
        np.testing.assert_allclose(getattr(model, k).w.detach().numpy(), params[k]["w"], atol=1e-7)
        assert np.abs(np.asarray(params[k]["w"]) - w[k]).max() > 1e-3  # it moved


def test_vovnet_simple_matches_jax():
    """The original's from-scratch trunk, vovnet57 (two blocks in stages 3
    and 4, so the residual path runs), at 32x96: c3 and c4 both at stride
    16, each to 1e-4 of its largest activation; its weights through the
    JAX package's `add_vovnet_scratch` porter and back, bit for bit."""
    x = np.random.default_rng(47).normal(size=(1, 32, 96, 3)).astype(np.float32)
    jm = JVoVNetSimple(model_name="vovnet57")
    variables = random_variables(jm, (jnp.asarray(x),), seed=49)
    want = jax.jit(lambda var, a: jm.apply(var, a))(variables, jnp.asarray(x))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             family="vovnet_simple", model_name="vovnet57")
    model = VoVNetSimple("vovnet57")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model.eval()(T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for k, ch in (("c3", 768), ("c4", 1024)):
        w = np.moveaxis(np.asarray(want[k]), 3, 1)
        assert got[k].shape == w.shape == (1, ch, 2, 6), k
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=k)
    porter = Porter()
    add_vovnet_scratch(porter, "", "", "vovnet57")
    params, batch_stats, missing = porter.run({k: t.numpy() for k, t in sd.items()})
    assert not missing
    for got_t, want_t in ((params, variables["params"]), (batch_stats, variables["batch_stats"])):
        got_t, want_t = _flat(got_t), _flat(want_t)
        assert got_t.keys() == want_t.keys()
        for k in want_t:
            np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)


@pytest.mark.parametrize("family", ["vovnet_pretrain", "vovnet_transformer"])
def test_stage_4_runs_only_at_lss_v2(family):
    """ROADMAP fault 7: stage 4 (c4) feeds the model only at LSS v2, where it
    runs once a forward, in eval and in training. At v1 nothing reads it:
    it does not run in eval, and in training it runs once a forward without
    autograd, for its batch-norm statistics alone (which move, while its
    output reaches nothing)."""
    args = _port_batch(camera_inputs(1, seed=51), _labels(53)[:1])
    calls = {}
    for v in ("v1", "v2"):
        _, cfg = _configs(family, v)
        model = build_model(cfg, device="cpu")
        stage4 = model.backbone.backbone.stages[3]
        grad_mode = []

        def record(m, inputs, output, v=v):
            calls.setdefault(v, []).append("train" if m.training else "eval")
            grad_mode.append(torch.is_grad_enabled())

        hook = stage4.register_forward_hook(record)
        before = {k: t.clone() for k, t in stage4.state_dict().items() if "running" in k}
        model(*(args[k] for k in tsteps.MODEL_INPUTS))
        tsteps.train_without_dropout(model)(*(args[k] for k in tsteps.MODEL_INPUTS))
        hook.remove()
        moved = [k for k, t in stage4.state_dict().items() if k in before
                 and not torch.equal(t, before[k])]
        assert moved and len(moved) == len(before), v
        assert grad_mode == ([True, True] if v == "v2" else [False]), v
    assert calls == {"v1": ["train"], "v2": ["eval", "train"]}
