"""The port's CLI (`lss2_multimodal_nu_tpu_torch/cli.py`) against the JAX
package's, on the CPU (`--device cpu`), and the JAX -> `.pt` converter
(`scripts/jax_checkpoint_to_pt.py`).

* Flags: each subcommand's parsed defaults equal the JAX CLI's key for key
  (both parsers run with the `run_*` functions patched, so nothing is built),
  and `--help` lists exactly the JAX CLI's flags plus `--device`.
* Wiring: the (split family, txt labels, test split, host shard) each
  subcommand hands `_loaders`.
* The slice against JAX: BevTxt b0 weights from a numpy seed (batch-norm
  statistics calibrated to the fixture's first test sample, as
  `test_torch_stack_a.py` calibrates to its inputs: otherwise the logits
  reach 4e5 and float32 round-off flips argmaxes), saved by the JAX
  package (Orbax) and converted, JAX's init replaced by zeros (the
  checkpoint overwrites every leaf; flax's op-by-op init takes 50 s here);
  JAX's `predict` beside the port's on the same fixture: the confusion
  matrices differ in at most 1e-4 of the pixels, each IoU within 1e-3, the
  loss within 1e-4 relative, the act/desc F1 lists equal, and `test.txt`
  has the same lines, its numbers within those limits.
* Stack B's chain, the port alone: pretrain-v2 writes `best_pretrained.pth`,
  train-v2 warm-starts from it by its default `--pretrained_path` (the four
  components bit for bit), writes its files, `--resume` restores
  `state_latest.pth` bit for bit, and `--resume` in an empty log directory
  still warm-starts.
* Stack A: pretrain, predict-iou on its `model0.pt`, train-onlybev.
* The converter: the three checkpoint formats read back by the JAX
  package's `port_checkpoint_file` to the original tree exactly, and a
  train state's Adam moments and count in the port's optimizer.

The fixture is the JAX package's `synthetic.generate` (2 mini_train and 1
mini_val scene, 2 samples each) at 90x160, small source images, since
Stack A needs its full 128x352 input (its BEV crop meets the camera
features there); Stack B runs at the dryrun grid (16 m, 32x32) and a 32x96
input."""
import contextlib
import json
import os
import re
import shutil
import sys
import unittest.mock as mock
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu import cli as jcli
from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.data import dataset as jds, nuscenes_index as jni, synthetic as jsyn
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.port.torch_port import port_checkpoint_file, port_state_dict
from lss2_multimodal_nu_tpu.train import checkpoint as jckpt, state as js, steps as jsteps
from lss2_multimodal_nu_tpu_torch import cli
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.models.vovnet_pretrain import PRETRAIN_COMPONENTS
from lss2_multimodal_nu_tpu_torch.train import checkpoint as ck, state as ts
from test_torch_modules import FINAL_DIM, XB, camera_inputs, random_variables
from test_torch_stack_a import _calibrated, _configs
from test_torch_train import _flat

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import jax_checkpoint_to_pt as conv  # noqa: E402

IMG = ["--H", "90", "--W", "160"]
DRYRUN = ["--xbound", *map(str, XB), "--ybound", *map(str, XB),
          "--final_dim", *map(str, FINAL_DIM)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, and the CLI's
    loader threads beside torch's own would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("nu")
    jsyn.generate(str(root / "mini"), samples_per_scene=2, seed=0)
    return str(root)


def _common(dataroot, *extra):
    """The port's flags for a run on the fixture: the CPU, one epoch, 2
    worker threads, a log row every step."""
    return ["--device", "cpu", "--version", "mini", "--dataroot", dataroot, *IMG,
            "--nepochs", "1", "--worker_type", "thread", "--nworkers", "2", "--log_every", "1",
            *extra]


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


# ---- the flags


def _parsed(module, cmd, extra=()):
    with mock.patch.object(module, "run_training", lambda args, *a, **k: args), \
         mock.patch.object(module, "run_predict", lambda args, *a, **k: args), \
         mock.patch.object(module, "run_predict_iou", lambda args, *a, **k: args):
        return module.main([cmd, "--dataroot", "/x", *extra])


@pytest.mark.parametrize("cmd", cli.FAMILY)
def test_defaults_match_the_jax_cli(cmd):
    """Every parsed default, per subcommand, is the JAX CLI's (the port adds
    `--device`, default `cuda`)."""
    want = vars(_parsed(jcli, cmd))
    got = vars(_parsed(cli, cmd))
    assert got.pop("device") == "cuda"
    assert got == want


def _help_flags(module, cmd, capsys):
    with pytest.raises(SystemExit) as e:
        module.main([cmd, "--help"])
    assert e.value.code == 0
    return set(re.findall(r"(?<![\w-])(--[a-z_][\w-]*)", capsys.readouterr().out))


@pytest.mark.parametrize("cmd", cli.FAMILY)
def test_help_lists_the_jax_flags_and_device(cmd, capsys):
    assert _help_flags(cli, cmd, capsys) == _help_flags(jcli, cmd, capsys) | {"--device"}


class _Stop(Exception):
    pass


def _wiring(module, cmd, tmp_path, extra=()):
    calls = {}

    def fake_loaders(cfg, with_txt, split_family, test=False, **kw):
        calls.update(with_txt=with_txt, split_family=split_family, test=test,
                     host_shard=kw.get("host_shard", (0, 1)))
        raise _Stop

    with mock.patch.object(module, "_loaders", fake_loaders), pytest.raises(_Stop):
        module.main([cmd, "--dataroot", "/x", "--logdir", str(tmp_path), *extra])
    return calls


@pytest.mark.parametrize("cmd", cli.FAMILY)
def test_loader_wiring_matches_the_jax_cli(cmd, tmp_path):
    assert _wiring(cli, cmd, tmp_path, ["--device", "cpu"]) == _wiring(jcli, cmd, tmp_path)


def test_device_cuda_without_a_card_exits(tmp_path, monkeypatch):
    """`--device cuda` (the default) with no card stops before any data or
    model; it never carries on on the CPU. Mesh flags whose product is not
    the number of processes (here one, no torchrun) stop with a message
    naming WORLD_SIZE."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "_loaders", mock.Mock(side_effect=AssertionError("reached data")))
    for cmd in ("train-v2", "predict"):
        with pytest.raises(SystemExit) as e:
            cli.main([cmd, "--dataroot", "/x", "--logdir", str(tmp_path)])
        assert "no CUDA device" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--device", "cpu", "--dp", "2"])
    assert "WORLD_SIZE=1" in str(e.value.code)


# ---- the slice against JAX: predict


@pytest.fixture(scope="module")
def bev_txt_b0(dataroot, tmp_path_factory):
    """BevTxt b0 variables, their batch-norm statistics calibrated to the
    fixture's first test sample, as an Orbax directory written by the JAX
    package and as the port's `.pt`, converted by the script. (Calibrated to
    random images, the fixture's logits reach 4e5.)"""
    jcfg, cfg = _configs("bev_txt", "b0")
    root = os.path.join(dataroot, "mini")
    item = jds.NuA2DDataset(jni.NuScenesIndex("v1.0-mini", root), False,
                            jconfig.AugConfig(H=90, W=160), jconfig.GridConfig(), root,
                            split="mini_val")[0]
    args = tuple(np.asarray(item[k])[None] for k in jsteps.MODEL_INPUTS)
    variables = _calibrated(cfg, random_variables(j_build_model(jcfg), args, seed=17), args)
    d = tmp_path_factory.mktemp("bev_txt")
    orbax, pt = str(d / "bev_txt_b0"), str(d / "bev_txt_b0.pt")
    jckpt.save_params(orbax, variables["params"], variables["batch_stats"])
    assert conv.convert(orbax, pt, ["predict", "--effnet_variant", "b0"]) == "bare"
    return variables, orbax, pt


_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e-?\d+)?")


def test_predict_matches_jax(bev_txt_b0, dataroot, tmp_path, capsys):
    variables, orbax, pt = bev_txt_b0
    flags = ["--version", "mini", "--dataroot", dataroot, *IMG, "--effnet_variant", "b0",
             "--nworkers", "2"]
    # the JAX CLI's init, which the checkpoint then overwrites leaf for leaf,
    # as zeros of the variables' shapes (flax's op-by-op init of BevTxt
    # compiles for about 50 s on the CPU)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)

    def init(*a, **k):
        return js.TrainState(step=np.int32(0), params=zeros["params"],
                             batch_stats=zeros["batch_stats"], opt_state=None, tx=None)

    with _cwd(tmp_path), mock.patch.object(js, "create_train_state", init):
        want = jcli.main(["predict", "--checkpoint", orbax, "--out_file", "jax.txt", *flags])
        got = cli.main(["predict", "--device", "cpu", "--checkpoint", pt, "--out_file", "port.txt",
                        "--viz_dir", "viz", "--viz_count", "1", *flags])
        assert os.path.getsize("viz/pred_000.png") > 0
        jlines = Path("jax.txt").read_text().splitlines()
        tlines = Path("port.txt").read_text().splitlines()
    assert "loaded ['encoder', 'camencode', 'bevencode'" in capsys.readouterr().out
    pixels = want["confmat"].sum()
    assert got["confmat"].sum() == pixels == 2 * 200 * 200
    assert np.abs(got["confmat"] - want["confmat"]).sum() / 2 <= 1e-4 * pixels
    np.testing.assert_allclose(got["iou"], want["iou"], atol=1e-3)
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    for k in ("act_f1", "desc_f1", "act_overall", "desc_overall", "act_mean", "desc_mean"):
        assert got[k] == want[k], k
    # test.txt: the checkpoint's line, then the same lines; the confusion
    # lines' percentages (one decimal) within two roundings of 1e-3
    assert (jlines[0], tlines[0]) == (orbax, pt) and len(jlines) == len(tlines)
    for a, b in zip(jlines[1:], tlines[1:]):
        assert _NUMBER.sub("#", a) == _NUMBER.sub("#", b)
        na, nb = map(float, _NUMBER.findall(a)), map(float, _NUMBER.findall(b))
        tol = 0.2 if "F1" not in a and "overall" not in a and "mean:" not in a.lower() else 0
        assert all(abs(x - y) <= tol + 1e-12 for x, y in zip(na, nb)), (a, b)


def test_predict_viz_needs_matplotlib(dataroot, tmp_path, monkeypatch):
    """Without matplotlib `--viz_dir` exits with a message saying so,
    before any data is read."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cli, "_loaders", mock.Mock(side_effect=AssertionError("reached data")))
    with pytest.raises(SystemExit) as e:
        cli.main(["predict", *_common(dataroot, "--viz_dir", str(tmp_path / "viz"))])
    assert "matplotlib" in str(e.value.code)


# ---- Stack B's chain through the CLI, the port alone


@pytest.fixture(scope="module")
def stack_b(dataroot, tmp_path_factory):
    """pretrain-v2 then train-v2 (default warm start; --wandb --wandb_watch
    without wandb installed writes the MetricLogger's files), in a fresh
    working directory, at the CLI's default log directories; the warm-started
    and resumed models' states are taken right after their restores."""
    d = tmp_path_factory.mktemp("stack_b")
    flags = [*DRYRUN, "--bsize", "2", "--eval_every", "1"]
    snapshots = []
    orig = cli._maybe_stage1_warmstart

    def spy(args, family, model, device, restored):
        orig(args, family, model, device, restored)
        if family == "vovnet_transformer":
            snapshots.append({k: v.clone() for k, v in model.state_dict().items()})

    out = {}
    with _cwd(d), mock.patch.object(cli, "_maybe_stage1_warmstart", spy):
        cli.main(["pretrain-v2", *_common(dataroot, *flags)])
        buf = _capture(lambda: cli.main(["train-v2", *_common(dataroot, *flags),
                                         "--ckpt_every", "1", "--wandb", "--wandb_watch"]))
        out["train"], out["train_log"] = buf
        out["resume"], out["resume_log"] = _capture(lambda: cli.main(
            ["train-v2", *_common(dataroot, *flags), "--resume"]))
        out["empty"], out["empty_log"] = _capture(lambda: cli.main(
            ["train-v2", *_common(dataroot, *flags), "--resume", "--nepochs", "0",
             "--logdir", "empty"]))
    out.update(dir=d, snapshots=snapshots)
    yield out
    shutil.rmtree(d, ignore_errors=True)  # about 1.5 GB of VoVNet-39 checkpoints


def _capture(fn):
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue()


def test_pretrain_v2_warm_starts_train_v2(stack_b):
    """train-v2's default `--pretrained_path` is the file pretrain-v2
    writes under its default log directory: the warm start fires, and the
    four components equal the file's bit for bit."""
    d = stack_b["dir"]
    best = d / "pretrain_vovnet" / ck.BEST_PRETRAINED
    assert "Loading pre-trained weights from: ./pretrain_vovnet/best_pretrained.pth" \
        in stack_b["train_log"]
    saved, meta = ck.model_state(ck.load_file(str(best), "cpu"))
    assert meta["format"] == "components" and meta["epoch"] == 1
    assert meta["lss_version"] == "v1" and 0 <= meta["miou"] <= 1
    warm = stack_b["snapshots"][0]
    assert {k.split(".")[0] for k in saved} == set(PRETRAIN_COMPONENTS)
    for k, v in saved.items():
        assert torch.equal(warm[k], v), k


def test_train_v2_writes_its_files(stack_b):
    d = stack_b["dir"] / "checkpoints_vovnet_transformer"
    for name in ("best_model_V3.pth", "state_latest.pth", "checkpoint_V3_epoch_1.pth"):
        assert (d / name).is_file(), name
    result = (d / "result.txt").read_text()
    assert result.startswith("epoch1global correct: ")
    for line in ("F1_info: ", "                F1_Action: [", "                Action_mean: ",
                 "                Description_mean: "):
        assert line in result
    # one row a step: 2 steps of the first run, 2 of the resume
    rows = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    # --wandb_watch with no wandb: the logger's files carry the per-module norms
    logged = [json.loads(x) for x in (d / "lss2-multimodal-nu-tpu.jsonl").read_text().splitlines()]
    assert "gradients/backbone_norm" in logged[0] and logged[0]["gradients/backbone_norm"] > 0
    assert "val/bev_miou" in logged[-1]
    # the model comes back in training mode, after validation
    assert stack_b["train"].training
    # the best model of the last run, the resume (whose best mIoU starts
    # afresh, as in the JAX CLI): its epoch 1, 2 steps on from step 2
    best = ck.load_file(str(d / "best_model_V3.pth"), "cpu")
    assert best["epoch"] == 1 and best["step"] == 4 and "best_miou" in best


def test_resume_restores_state_latest(stack_b):
    """--resume loads `state_latest.pth` (model, optimizer, scheduler, the
    step) and skips the warm start; the epochs start again at 1."""
    log = stack_b["resume_log"]
    assert "resuming from ./checkpoints_vovnet_transformer/state_latest.pth" in log
    assert "Loading pre-trained weights" not in log and "Epoch: 1-" in log
    # the file now holds the resumed run's state: 2 steps on from 2
    latest = ck.load_file(str(stack_b["dir"] / "checkpoints_vovnet_transformer" /
                              ck.STATE_LATEST), "cpu")
    assert latest["step"] == 4
    trained = stack_b["train"].state_dict()
    for k, v in stack_b["snapshots"][1].items():
        assert torch.equal(v, trained[k]), k


def test_resume_with_nothing_to_restore_warm_starts(stack_b):
    """--resume in an empty log directory restored nothing, so train-v2
    still warm-starts from pretrain-v2's file (the JAX CLI does not)."""
    assert "Loading pre-trained weights from: ./pretrain_vovnet/best_pretrained.pth" \
        in stack_b["empty_log"]
    saved, _ = ck.model_state(ck.load_file(str(stack_b["dir"] / "pretrain_vovnet" /
                                               ck.BEST_PRETRAINED), "cpu"))
    for k, v in saved.items():
        assert torch.equal(stack_b["snapshots"][2][k], v), k


def test_evaluate_leaves_train_mode_and_statistics(stack_b, dataroot):
    """`_evaluate` runs the model in eval mode and hands it back in
    training mode with its batch-norm statistics untouched."""
    args = cli.build_parser().parse_args(["pretrain-v2", *_common(dataroot, *DRYRUN),
                                          "--bsize", "2"])
    cfg = cli._build_cfg(args, "vovnet_pretrain")
    _, val = cli._loaders(cfg, False, "nuscenes_full", nworkers=1, device="cpu")
    model = build_model(cfg, "cpu", seed=0).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    info = cli._evaluate(cfg, model, val)
    assert model.training and info["confmat"].sum() == 2 * 32 * 32
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---- Stack A through the CLI


def test_stack_a_pretrain_predict_iou_and_onlybev(dataroot, tmp_path):
    """pretrain (LSS b0, one epoch) writes `model0.pt` and
    `pretrain-result.txt`; predict-iou on that file writes the checkpoint /
    val_loss surface; train-onlybev runs an epoch."""
    a_flags = ["--effnet_variant", "b0", "--bsize", "2"]
    with _cwd(tmp_path):
        cli.main(["pretrain", *_common(dataroot, *a_flags)])
        model0 = tmp_path / "pretrain_result" / "model0.pt"
        assert ck.model_state(ck.load_file(str(model0), "cpu"))[1]["format"] == "bare"
        result = (tmp_path / "pretrain_result" / "pretrain-result.txt").read_text()
        assert result.startswith("epoch0global correct: ") and "\nval_loss: " in result
        info = cli.main(["predict-iou", *_common(dataroot, "--effnet_variant", "b0"),
                         "--checkpoint", str(model0)])
        b1 = Path("b1_20.txt").read_text()
        assert b1.startswith(f"checkpoint:{model0}global correct: ")
        assert f"\nval_loss: {info['loss']}\n" in b1 and np.isfinite(info["loss"])
        model = cli.main(["train-onlybev", *_common(dataroot, *a_flags)])
        assert model.training and (tmp_path / "result-log" / "model0.pt").is_file()
        assert "F1_Action" in (tmp_path / "result-log" / "result.txt").read_text()


# ---- the converter


def test_converter_components_round_trip(tmp_path):
    """pretrain-v2's components (LSS v1) -> `.pt` -> the JAX package's
    porter: the four components exactly, and the epoch, mIoU and version."""
    jcfg = jconfig.Config(grid=jconfig.GridConfig(xbound=XB, ybound=XB),
                          aug=jconfig.AugConfig(final_dim=FINAL_DIM),
                          model=jconfig.ModelConfig(family="vovnet_pretrain", lss_version="v1"))
    v = random_variables(j_build_model(jcfg), camera_inputs(1, seed=5), seed=6)
    src, dst = str(tmp_path / "best_pretrained"), str(tmp_path / "best_pretrained.pth")
    jckpt.save_components(src, v["params"], v["batch_stats"], PRETRAIN_COMPONENTS,
                          extra={"epoch": 3, "miou": 0.25, "lss_version": "v1"})
    assert conv.convert(src, dst, ["pretrain-v2", *DRYRUN]) == "components"
    params, stats, report = port_checkpoint_file(dst, "vovnet_transformer", strict=False,
                                                 lss_version="v1")
    shutil.rmtree(tmp_path, ignore_errors=True)
    assert (report["format"], report["epoch"], report["miou"], report["lss_version"]) == (
        "components", 3, 0.25, "v1")
    assert not report["unmapped"]
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        assert _flat(got).keys() == _flat(want).keys()
        for k, x in _flat(want).items():
            np.testing.assert_array_equal(_flat(got)[k], x, err_msg=k)


def test_converter_bare_round_trip(bev_txt_b0):
    variables, _, pt = bev_txt_b0
    params, stats, report = port_checkpoint_file(pt, "bev_txt", variant="b0")
    assert report["format"] == "flat" and not report["missing"] and not report["unmapped"]
    for got, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        assert _flat(got).keys() == _flat(want).keys()
        for k, x in _flat(want).items():
            np.testing.assert_array_equal(_flat(got)[k], x, err_msg=k)


def test_converter_train_state(tmp_path):
    """A train-v2 flagship state (LSS v1, two Adam groups through optax's
    multi_transform, step 7, seeded moments) -> `.pt`: the weights read back
    by the JAX porter exactly; in the port's optimizer each parameter's
    exp_avg / exp_avg_sq, carried back by the JAX porter, are optax's mu /
    nu exactly, its step is 7, and the scheduler stands at step 7."""
    jcfg = jconfig.Config(
        grid=jconfig.GridConfig(xbound=XB, ybound=XB), aug=jconfig.AugConfig(final_dim=FINAL_DIM),
        model=jconfig.ModelConfig(family="vovnet_transformer", lss_version="v1"),
        train=jconfig.TrainConfig(use_schedule=True, num_epochs=60))
    v = random_variables(j_build_model(jcfg), camera_inputs(1, seed=7), seed=8)
    tx = js.build_optimizer(jcfg, steps_per_epoch=3)
    rng = np.random.default_rng(9)
    opt_state = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, 7, x.dtype) if x.dtype == np.int32
        else rng.uniform(0.0, 1.0, x.shape).astype(x.dtype), tx.init(v["params"]))
    state = js.TrainState(step=np.int32(7), params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=opt_state, tx=tx)
    src, dst = str(tmp_path / "state_latest"), str(tmp_path / "state_latest.pth")
    jckpt.save_train_state(src, state, {"epoch": 2, "best_miou": 0.5})
    with pytest.raises(SystemExit):
        conv.convert(src, dst, ["train-v2", *DRYRUN])  # a scheduled state needs steps_per_epoch
    assert conv.convert(src, dst, ["train-v2", *DRYRUN, "--steps_per_epoch", "3"]) == "full_state"

    params, _, report = port_checkpoint_file(dst, "vovnet_transformer", lss_version="v1")
    assert (report["epoch"], report["best_miou"]) == (2, 0.5)
    for k, x in _flat(v["params"]).items():
        np.testing.assert_array_equal(_flat(params)[k], x, err_msg=k)

    args = cli.build_parser().parse_args(["train-v2", *DRYRUN])
    cfg = cli._build_cfg(args, "vovnet_transformer")
    model = build_model(cfg, "cpu", seed=1)
    opt, sched = ts.build_optimizer(cfg, model, steps_per_epoch=3)
    meta = ck.restore_train_state(dst, model, opt, sched, map_location="cpu")
    assert (meta["step"], meta["epoch"], sched.last_epoch) == (7, 2, 7)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx(
        [1e-5 * 7 / 15, 1e-4 * 7 / 15], rel=1e-12)  # warmup: 7 of 5 epochs x 3 steps
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    names = dict(model.named_parameters())
    adam = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")]
    assert len(adam) == 2
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        carried = dict(sd, **{n: opt.state[p][key].numpy() for n, p in names.items()})
        got = _flat(port_state_dict("vovnet_transformer", carried, lss_version="v1")[0])
        for a in adam:  # each group's moments where its mask keeps them
            for k, x in _flat(getattr(a, moment)).items():
                np.testing.assert_array_equal(got[k], x, err_msg=k)
    assert all(float(opt.state[p]["step"]) == 7.0 for p in names.values())
    shutil.rmtree(tmp_path, ignore_errors=True)
