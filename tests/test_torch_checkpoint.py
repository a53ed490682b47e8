"""The port's checkpoints (`train/checkpoint.py`), in the original repo's
three `.pt` formats, on the CPU:

* the round trip: a JAX variable tree, saved and restored through Orbax by
  the JAX package, carried into the port by `state_dict_from_jax` and
  written by the port in each format, reads back through the JAX package's
  `port_checkpoint_file` to the original tree exactly (the flagship and
  BevTxt bare and as full state, the pretrain model as components);
* the warm start (stage 1 -> stage 2, and Stack A's LSS -> BevTxt),
  module by top-level module, a mismatched module dropped whole;
* resume: two steps, save, restore into fresh objects, one more step
  equals three uninterrupted steps bit for bit;
* `latest_checkpoint`, `AsyncSaver` and `PreemptionHandler` as the JAX
  package's tests expect of theirs (`tests/test_cli_and_ckpt.py`);
* every file the port writes loads with `torch.load(weights_only=True)`.

Models are at the dryrun shapes of `test_torch_model.py` (6 cameras at
32x96, a 32x32 BEV grid); Stack A's at its default grid, which its crop
needs, with EfficientNet-b0."""
import os
import signal
import zipfile

import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.port.torch_port import port_checkpoint_file, port_state_dict
from lss2_multimodal_nu_tpu.train import checkpoint as jckpt
from lss2_multimodal_nu_tpu_torch import config as tconfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.models.vovnet_pretrain import PRETRAIN_COMPONENTS
from lss2_multimodal_nu_tpu_torch.port import state_dict_from_jax
from lss2_multimodal_nu_tpu_torch.train import checkpoint as ck, state as ts, steps as tsteps
from test_torch_modules import FINAL_DIM, XB, camera_inputs, random_variables
from test_torch_train import _flat


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    own threads in each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy


def _cfg(family, dryrun=True, **model):
    """The port's and the JAX package's configs of a family."""
    kw = dict(grid=dict(xbound=XB, ybound=XB), aug=dict(final_dim=FINAL_DIM)) if dryrun else {}
    train = dict(use_schedule=True, num_epochs=4, warmup_epochs=1)
    cfg = tconfig.Config(grid=tconfig.GridConfig(**kw.get("grid", {})),
                         aug=tconfig.AugConfig(**kw.get("aug", {})),
                         model=tconfig.ModelConfig(family=family, **model),
                         train=tconfig.TrainConfig(**train))
    jcfg = jconfig.Config(grid=jconfig.GridConfig(**kw.get("grid", {})),
                          aug=jconfig.AugConfig(**kw.get("aug", {})),
                          model=jconfig.ModelConfig(family=family, **model))
    return cfg, jcfg


def _equal_trees(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# family -> (port model flags, the porters' flags, dryrun shapes, port formats)
ROUND_TRIPS = {
    "vovnet_transformer": (dict(lss_version="v1"), dict(lss_version="v1"), True,
                           ("bare", "full_state")),
    "bev_txt": (dict(effnet_variant="b0"), dict(variant="b0"), False, ("bare", "full_state")),
    "vovnet_pretrain": (dict(lss_version="v1"), dict(lss_version="v1"), True, ("components",)),
}


@pytest.fixture(scope="module", params=list(ROUND_TRIPS))
def orbax_round_trip(request, tmp_path_factory):
    """(family, the JAX variables, the JAX porter's flags, {format: the
    port's file}): the variables saved with the JAX package's Orbax
    `save_params`, restored with `load_tree`, carried into the port's model
    and written by the port."""
    family = request.param
    model_flags, porter_flags, dryrun, formats = ROUND_TRIPS[family]
    cfg, jcfg = _cfg(family, dryrun, **model_flags)
    args = camera_inputs(1, seed=61) if dryrun else camera_inputs(1, h=128, w=352, seed=61)
    variables = random_variables(j_build_model(jcfg), args, seed=63)
    d = tmp_path_factory.mktemp(family)
    jckpt.save_params(str(d / "orbax"), variables["params"], variables["batch_stats"])
    tree = jckpt.load_tree(str(d / "orbax"))
    flags = dict(effnet_variant=model_flags["effnet_variant"]) if family == "bev_txt" else model_flags
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(tree["params"], tree["batch_stats"], family=family,
                                              **flags))
    files = {}
    for fmt in formats:
        files[fmt] = str(d / f"{fmt}.pt")
        if fmt == "bare":
            ck.save_params(files[fmt], model)
        elif fmt == "components":
            ck.save_components(files[fmt], model, epoch=5, miou=0.5, lss_version="v1")
        else:
            opt, sched = ts.build_optimizer(cfg, model, steps_per_epoch=1)
            ck.save_train_state(files[fmt], model, opt, sched, step=7, epoch=2, best_miou=0.25)
    return family, variables, porter_flags, files


def test_port_files_read_back_to_the_jax_tree(orbax_round_trip):
    """`port_checkpoint_file` reads each of the port's files to the Orbax
    tree exactly. The pretrain's components go through the flagship's
    porter with strict=False (the porter has no pretrain rule): the four
    components come back, nothing else."""
    family, variables, porter_flags, files = orbax_round_trip
    porter_family = "vovnet_transformer" if family == "vovnet_pretrain" else family
    for fmt, path in files.items():
        params, batch_stats, report = port_checkpoint_file(path, porter_family, strict=False,
                                                           **porter_flags)
        assert report["format"] == {"bare": "flat"}.get(fmt, fmt)
        assert not report["unmapped"], report["unmapped"][:5]
        if fmt == "components":
            assert (report["epoch"], report["miou"], report["lss_version"]) == (5, 0.5, "v1")
            assert sorted(report["components"]) == sorted(PRETRAIN_COMPONENTS)
            assert report["missing"] and all(
                k.split(".")[0] not in PRETRAIN_COMPONENTS for k in report["missing"])
        else:
            assert not report["missing"]
        if fmt == "full_state":
            assert (report["epoch"], report["best_miou"]) == (2, 0.25)
        _equal_trees(params, variables["params"])
        _equal_trees(batch_stats, variables["batch_stats"])


# ---- the warm start


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_stage_1_components_warm_start_the_flagship(tmp_path):
    """pretrain-v2's `best_pretrained.pth` into train-v2's flagship (both
    LSS v1): the four components bit for bit, every other tensor at the
    flagship's init."""
    cfg_p, _ = _cfg("vovnet_pretrain", lss_version="v1")
    cfg_f, _ = _cfg("vovnet_transformer", lss_version="v1")
    pretrain = build_model(cfg_p, device="cpu", seed=1)
    path = str(tmp_path / ck.BEST_PRETRAINED)
    ck.save_components(path, pretrain, epoch=10, miou=0.3, lss_version="v1")
    flagship = build_model(cfg_f, device="cpu", seed=2)
    init = _state(flagship)
    report = ck.restore_loose(path, flagship, map_location="cpu")
    assert report["loaded"] == list(PRETRAIN_COMPONENTS) and not report["dropped"]
    assert report["format"] == "components" and report["epoch"] == 10
    assert "feature_pyramid" in report["absent"] and not report["unexpected"]
    want = pretrain.state_dict()
    for k, v in flagship.state_dict().items():
        if k.split(".")[0] in PRETRAIN_COMPONENTS:
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, init[k]), k
    assert not torch.equal(init["backbone.backbone.stem.0.conv.weight"],
                           want["backbone.backbone.stem.0.conv.weight"])


def test_mismatched_component_is_dropped_whole(tmp_path):
    """Like the original repo, unlike the JAX package's leaf-by-leaf
    `merge_loose` (ROADMAP fault 6c): a component that does not fit is
    dropped whole and left at its init. (a) an LSS v2 pretrain file into the
    v1 flagship: the depth nets differ in every key, `depth_net` is dropped,
    the other three load. (b) a pretrain with 5 BEV classes into the
    4-class flagship: one leaf of `bev_encoder` has another shape; the port
    drops the whole `bev_encoder`, where `merge_loose` would take its other
    leaves."""
    flagship_cfg, _ = _cfg("vovnet_transformer", lss_version="v1")
    for case, flags, bad in (("a", dict(lss_version="v2"), "depth_net"),
                             ("b", dict(lss_version="v1", seg_classes=5), "bev_encoder")):
        pretrain = build_model(_cfg("vovnet_pretrain", **flags)[0], device="cpu", seed=3)
        path = str(tmp_path / f"{case}.pth")
        ck.save_components(path, pretrain, epoch=1)
        flagship = build_model(flagship_cfg, device="cpu", seed=4)
        init = _state(flagship)
        report = ck.restore_loose(path, flagship, map_location="cpu")
        assert list(report["dropped"]) == [bad], case
        assert report["loaded"] == [c for c in PRETRAIN_COMPONENTS if c != bad], case
        want = pretrain.state_dict()
        for k, v in flagship.state_dict().items():
            comp = k.split(".")[0]
            ref = want[k] if comp in PRETRAIN_COMPONENTS and comp != bad else init[k]
            assert torch.equal(v, ref), (case, k)
    # (b) under the JAX package's merge: every bev_encoder leaf but the 5-class one moves
    np_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    mine = port_state_dict("vovnet_transformer", np_sd(flagship), strict=False,
                           lss_version="v1")[0]["bev_encoder"]
    theirs = port_state_dict("vovnet_transformer", np_sd(pretrain), strict=False,
                             lss_version="v1")[0]["bev_encoder"]
    merged = _flat(jckpt.merge_loose(mine, theirs))
    not_taken = [k for k, v in merged.items() if not np.array_equal(v, _flat(theirs)[k])]
    assert not_taken == ["['seg_out']['bias']", "['seg_out']['kernel']"]


def test_lss_warm_starts_bev_txt(tmp_path):
    """Stack A's chain: a bare LSS file into BevTxt (both b0). The port
    keeps the original's root names in both, so `encoder`, `camencode` and
    `bevencode` transfer with no re-rooting; BevTxt's own modules keep their
    init."""
    lss = build_model(_cfg("lss", dryrun=False, effnet_variant="b0")[0], device="cpu", seed=5)
    path = str(tmp_path / ck.MODEL_FILE.format(epoch=0))
    ck.save_params(path, lss)
    bev_txt = build_model(_cfg("bev_txt", dryrun=False, effnet_variant="b0")[0], device="cpu",
                          seed=6)
    init = _state(bev_txt)
    report = ck.restore_loose(path, bev_txt, map_location="cpu")
    assert report["loaded"] == ["encoder", "camencode", "bevencode"]
    assert report["format"] == "bare" and not report["dropped"] and not report["unexpected"]
    want = lss.state_dict()
    for k, v in bev_txt.state_dict().items():
        assert torch.equal(v, want[k] if k in want else init[k]), k


# ---- resume


def _steps(model, opt, sched, batch, steps):
    return [tsteps.train_step(model, opt, sched, batch, s)["loss"] for s in steps]


def test_resume_repeats_the_uninterrupted_run(tmp_path):
    """The pretrain model in training mode, dropout on (seeded by the
    step), under the warmup-cosine schedule: `state_latest` saved after two
    steps of a run that goes on to a third, restored into a model, optimizer
    and scheduler made afresh from another seed, one more step; it equals
    the uninterrupted run's third step bit for bit: the loss, every
    parameter and buffer, the Adam moments and the rate."""
    cfg, _ = _cfg("vovnet_pretrain", lss_version="v1")
    args = camera_inputs(1, seed=65)
    batch = dict(zip(tsteps.MODEL_INPUTS,
                     [T(np.ascontiguousarray(args[0].transpose(0, 1, 4, 2, 3)))]
                     + [T(a) for a in args[1:]]),
                 binimg=T(np.random.default_rng(67).integers(0, 4, size=(1, 32, 32))))

    def fresh(seed):
        model = build_model(cfg, device="cpu", seed=seed).train()
        return (model, *ts.build_optimizer(cfg, model, steps_per_epoch=1))

    a = fresh(0)
    losses_a = _steps(*a, batch, range(2))
    path = str(tmp_path / ck.STATE_LATEST)
    ck.save_train_state(path, *a, step=2, epoch=2, best_miou=0.1)
    losses_a += _steps(*a, batch, [2])
    c = fresh(9)
    meta = ck.restore_train_state(path, *c, map_location="cpu")
    assert meta == {"step": 2, "epoch": 2, "best_miou": 0.1}
    (loss_c,) = _steps(*c, batch, range(meta["step"], 3))
    assert torch.equal(loss_c, losses_a[2])
    for k, v in a[0].state_dict().items():
        assert torch.equal(v, c[0].state_dict()[k]), k
    sa, sc = a[1].state_dict(), c[1].state_dict()
    assert sa["param_groups"] == sc["param_groups"] and sa["state"].keys() == sc["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sc["state"][i][k]), (i, k)
    assert a[2].state_dict() == c[2].state_dict()


# ---- the helpers


def test_latest_checkpoint(tmp_path):
    for e in (0, 3, 11):
        (tmp_path / ck.MODEL_FILE.format(epoch=e)).touch()
    (tmp_path / "model12.pt.tmp").touch()  # a write in progress
    assert ck.latest_checkpoint(str(tmp_path)).endswith("model11.pt")
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None


def test_async_saver_roundtrip(tmp_path):
    """The saver copies the weights before `save_params` returns: a change
    to the model right after does not reach the file."""
    model = torch.nn.Linear(3, 2)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    saver = ck.AsyncSaver()
    path = str(tmp_path / "async.pt")
    saver.save_params(path, model)
    with torch.no_grad():
        model.weight.add_(1.0)
    saver.wait()
    got = torch.load(path, weights_only=True)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    saver.close()


def test_preemption_handler():
    prev = signal.getsignal(signal.SIGTERM)
    h = ck.PreemptionHandler()
    try:
        assert not h.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop()
    finally:
        h.close()
    assert signal.getsignal(signal.SIGTERM) == prev


# ---- loading


def test_port_files_load_weights_only(tmp_path):
    """Every file the port writes holds tensors and plain Python values
    only: `torch.load(weights_only=True)` reads it with nothing allowed
    besides."""
    cfg, _ = _cfg("vovnet_pretrain", lss_version="v1")
    model = build_model(cfg, device="cpu")
    opt, sched = ts.build_optimizer(cfg, model.train(), steps_per_epoch=1)
    args = camera_inputs(1, seed=69)
    batch = dict(zip(tsteps.MODEL_INPUTS,
                     [T(np.ascontiguousarray(args[0].transpose(0, 1, 4, 2, 3)))]
                     + [T(a) for a in args[1:]]),
                 binimg=T(np.zeros((1, 32, 32), np.int64)))
    tsteps.train_step(model, opt, sched, batch, 0)  # Adam's state is not empty
    saver = ck.AsyncSaver()
    writes = {
        "bare": lambda p: ck.save_params(p, model),
        "components": lambda p: ck.save_components(p, model, epoch=np.int64(3),
                                                   miou=np.float64(0.5), lss_version="v1"),
        "full_state": lambda p: ck.save_train_state(p, model, opt, sched, step=1,
                                                    epoch=np.int64(1), best_miou=np.float32(0.5)),
        "async": lambda p: saver.save_params(p, model),
    }
    for name, write in writes.items():
        write(str(tmp_path / name))
    saver.close()
    for name in writes:
        obj = torch.load(str(tmp_path / name), weights_only=True)
        assert isinstance(obj, dict) and obj, name
    assert type(torch.load(str(tmp_path / "components"), weights_only=True)["miou"]) is float


def test_load_file_reads_numpy_scalars_of_the_original(tmp_path):
    """The original repo's files may hold numpy scalars beside the weights
    (an mIoU from numpy, pickled under numpy 1's module name or numpy 2's):
    plain `weights_only=True` refuses them; `load_file` allows numpy's
    scalars and nothing more."""
    sd = {"w": torch.ones(2)}
    torch.save({"model_state_dict": sd, "epoch": 3, "best_miou": np.float64(0.5)},
               tmp_path / "numpy2.pth")
    # the same file as numpy 1 pickles it
    with zipfile.ZipFile(tmp_path / "numpy2.pth") as zin, \
            zipfile.ZipFile(tmp_path / "numpy1.pth", "w", zipfile.ZIP_STORED) as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith("data.pkl"):
                data = data.replace(b"numpy._core.multiarray", b"numpy.core.multiarray")
            zout.writestr(item, data)
    for name in ("numpy2.pth", "numpy1.pth"):
        with pytest.raises(Exception, match="[Ww]eights only"):
            torch.load(tmp_path / name, weights_only=True)
        obj = ck.load_file(str(tmp_path / name), map_location="cpu")
        assert obj["best_miou"] == 0.5 and torch.equal(obj["model_state_dict"]["w"], sd["w"])
