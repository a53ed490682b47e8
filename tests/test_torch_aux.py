"""The port's utilities against the JAX package's, on the CPU, bit for bit
where the arithmetic is the same:

* `data/map_gen.py::generate_binmaps` on the JAX package's
  `synthetic.generate_map_expansion` map, every raster (the JAX package
  fills with OpenCV, the port with `data/raster.py`);
* `data/lidar.py::get_lidar_data` and `VizDataset`'s 'lidar' on the fixture's
  lidar sweeps;
* `utils/visualize.py`: `ego_footprint_points`, `bev_to_rgb`,
  `side_by_side`, `save_bev_png` (written with zlib, read back with PIL in
  this test) and the matplotlib figure;
* `utils/logging.py::MetricLogger`'s JSONL and CSV files, byte for byte
  (the clock fixed);
* `train/steps.py::grad_watch_summaries` on the same gradients: the samples
  exactly, the norms up to float32 round-off (5e-7 relative);
* `config.py::preset`, and `utils/profiling.py`.

The fixture is the JAX package's `synthetic.generate` at 90x160, one module
fixture for every check."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.data import dataset as jds, lidar as jlidar, map_gen as jmap
from lss2_multimodal_nu_tpu.data import nuscenes_index as jni, synthetic as jsyn
from lss2_multimodal_nu_tpu.train import steps as jsteps
from lss2_multimodal_nu_tpu.utils import logging as jlog, visualize as jviz
from lss2_multimodal_nu_tpu_torch import config as tconfig
from lss2_multimodal_nu_tpu_torch.core.grid import gen_dx_bx
from lss2_multimodal_nu_tpu_torch.data import dataset as tds, lidar as tlidar, map_gen as tmap
from lss2_multimodal_nu_tpu_torch.data import nuscenes_index as tni
from lss2_multimodal_nu_tpu_torch.train import steps as tsteps
from lss2_multimodal_nu_tpu_torch.utils import logging as tlog, profiling, visualize as tviz

AUG = dict(H=90, W=160)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, and the CLI's
    loader threads beside torch's own would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The fixture (3 scenes, 2 samples each) and a map-expansion JSON."""
    r = str(tmp_path_factory.mktemp("nu") / "mini")
    jsyn.generate(r, samples_per_scene=2, seed=0)
    jsyn.generate_map_expansion(r, seed=0)
    return r


@pytest.fixture(scope="module")
def indexes(root):
    return jni.NuScenesIndex("v1.0-mini", root), tni.NuScenesIndex("v1.0-mini", root)


def test_generate_binmaps_matches_jax(root, indexes, tmp_path):
    jnusc, tnusc = indexes
    scene_to_map = {jnusc.get("scene", s["scene_token"])["name"]: "boston-seaport"
                    for s in jnusc.sample}
    dx, bx = _grid()
    n_j = jmap.generate_binmaps(jnusc, root, scene_to_map, str(tmp_path / "j"), dx, bx)
    n_t = tmap.generate_binmaps(tnusc, root, scene_to_map, str(tmp_path / "t"), dx, bx)
    assert n_j == n_t == len(jnusc.sample)
    filled = 0
    for name in sorted(os.listdir(tmp_path / "j")):
        want, got = np.load(tmp_path / "j" / name), np.load(tmp_path / "t" / name)
        assert got.dtype == want.dtype and got.shape == want.shape == (200, 200)
        np.testing.assert_array_equal(got, want, err_msg=name)
        filled += int((want == 3).any() and (want == 2).any())
    assert filled  # the map reaches the samples: both classes drawn


def test_lidar_and_viz_dataset_match_jax(root, indexes):
    """`get_lidar_data` over 3 sweeps (the fixture's samples have no `prev`,
    so one) and `VizDataset`'s items, every key, against JAX's."""
    jnusc, tnusc = indexes
    for rec_j, rec_t in zip(jnusc.sample, tnusc.sample):
        want = jlidar.get_lidar_data(jnusc, rec_j, nsweeps=3, min_distance=2.2)
        got = tlidar.get_lidar_data(tnusc, rec_t, nsweeps=3, min_distance=2.2)
        assert want.shape[0] == 5 and want.shape[1] > 0
        np.testing.assert_array_equal(got, want)
    jv = jds.VizDataset(jnusc, False, jconfig.AugConfig(**AUG), jconfig.GridConfig(), root,
                        split="mini_val")
    tv = tds.VizDataset(tnusc, False, tconfig.AugConfig(**AUG), tconfig.GridConfig(), root,
                        split="mini_val", device="cpu")
    want, got = jv[1], tv[1]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k == "imgs":
            g = g.transpose(0, 2, 3, 1)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _grid():
    dx, bx, _ = gen_dx_bx((-50.0, 50.0, 0.5), (-50.0, 50.0, 0.5), (-10.0, 10.0, 20.0))
    return dx, bx


def test_visualize_matches_jax(tmp_path):
    dx, bx = _grid()
    np.testing.assert_array_equal(tviz.ego_footprint_points(bx, dx),
                                  jviz.ego_footprint_points(bx, dx))
    rng = np.random.default_rng(0)
    pred, gt = rng.integers(0, 4, (200, 200)), rng.integers(0, 4, (200, 200))
    for args in ((pred,), (pred, True, bx, dx), (pred, False, bx, dx)):
        np.testing.assert_array_equal(tviz.bev_to_rgb(*args), jviz.bev_to_rgb(*args))
    assert (tviz.bev_to_rgb(pred, True, bx, dx) == tviz.EGO_COLOR).all(-1).sum() > 0
    np.testing.assert_array_equal(tviz.side_by_side(pred, gt), jviz.side_by_side(pred, gt))
    for kw in ({}, dict(bx=bx, dx=dx)):
        tviz.save_bev_png(str(tmp_path / "t.png"), pred[:37, :53], **kw)
        jviz.save_bev_png(str(tmp_path / "j.png"), pred[:37, :53], **kw)
        t, j = Image.open(tmp_path / "t.png"), Image.open(tmp_path / "j.png")
        assert t.mode == j.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def test_prediction_figure(tmp_path):
    """The composed figure renders the port's NCHW camera images (matplotlib
    is installed here, not on the card's machine)."""
    dx, bx = _grid()
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(6, 3, 32, 88)).astype(np.float32)
    want = jds.denormalize_img(imgs[2].transpose(1, 2, 0))
    np.testing.assert_array_equal(tviz.denormalize_img(imgs[2]), np.asarray(want))
    polys = {"road_segment": [np.array([[0.0, 0.0], [10, 0], [10, 10]])], "lane": [],
             "road_divider": [np.array([[0.0, 1.0], [5, 1]])], "lane_divider": []}
    fig = tviz.compose_prediction_figure(imgs, rng.integers(0, 4, (200, 200)), bx, dx,
                                         polys=polys, lidar_pts=rng.normal(size=(3, 50)),
                                         out_path=str(tmp_path / "f.png"))
    assert len(fig.axes) == 7 and os.path.getsize(tmp_path / "f.png") > 0


def test_metric_logger_files_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    rows = [(1, {"train/loss": 0.5, "gradients/backbone_norm": np.float32(2.25),
                 "gradients/backbone": np.arange(4.0)}),
            (2, {"train/loss": torch.tensor(0.25), "val/extra": 3}),
            (3, {"epoch": 1, "val/loss": 0.125, "name": "x"})]
    for mod, d in ((jlog, "j"), (tlog, "t")):
        logger = mod.MetricLogger(str(tmp_path / d), run_name="run", use_wandb=True)
        for step, row in rows:
            logger.log(step, {k: (v.numpy() if mod is jlog and hasattr(v, "numpy") else v)
                              for k, v in row.items()})
        logger.close()
    for name in ("run.jsonl", "run.csv"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert json.loads((tmp_path / "t" / "run.jsonl").read_text().splitlines()[1]) == {
        "step": 2, "time": 1234.5, "train/loss": 0.25, "val/extra": 3.0}


def test_grad_watch_summaries_match_jax():
    """Per-module norms and strided samples, on gradients shaped like a
    model's (a 4-D kernel, biases, a leaf smaller than its share, a module
    with more leaves than the sample), JAX's leaf order on both sides."""
    rng = np.random.default_rng(3)
    shapes = {"backbone": {"conv": {"kernel": (3, 3, 16, 32), "bias": (32,)},
                           "bn": {"scale": (32,), "bias": (32,)}},
              "head": {"w": (1000, 7), "b": (1,)},
              "many": {f"l{i:04d}": (3,) for i in range(2100)}}
    grads = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
    want = jsteps.grad_watch_summaries(jax.tree_util.tree_map(jnp.asarray, grads))
    got = tsteps.grad_watch_summaries({
        mod: [torch.from_numpy(x) for x in jax.tree_util.tree_leaves(sub)]
        for mod, sub in grads.items()})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        if k.startswith("grad_sample/"):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(float(got[k]), float(w), rtol=5e-7, err_msg=k)
    assert want["grad_sample/many"].shape == (2048,)


def test_presets_match_jax():
    for name in ("pretrain", "train", "train_onlybev", "pretrain_v2", "train_v2"):
        want, got = jconfig.preset(name), tconfig.preset(name)
        for part in ("grid", "aug", "model", "train"):
            w, g = vars(getattr(want, part)), vars(getattr(got, part))
            shared = {k: w[k] for k in g if k in w}
            assert {k: g[k] for k in shared} == shared, (name, part)
        assert (got.dataroot, got.version, got.logdir) == (want.dataroot, want.version,
                                                            want.logdir)
    with pytest.raises(ValueError):
        tconfig.preset("nope")


def test_profiling(tmp_path):
    timer = profiling.StepTimer(frames_per_step=6, device="cpu")
    for _ in range(3):
        with timer.step():
            torch.ones(64, 64).sum()
    s = timer.summary()
    assert s["steps"] == 3 and s["p50_ms"] > 0 and s["frames_per_sec"] > 0
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    profiling.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
