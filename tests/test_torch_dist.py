"""The port's runs on more than one device (`lss2_multimodal_nu_tpu_torch/parallel/`,
`--dp`/`--fsdp`) on the CPU: two gloo ranks, started once for the module.

The ranks run `parallel/dryrun.py::run_rank` (spawned, one torch thread
each, a file store under the module's temporary directory) over the jobs
of `tests/torch_dist_jobs.py`, which write their numpy results to files;
the tests read them. Meanwhile this
process computes the single-process references on one thread. The
contract is the JAX package's `tests/test_dist.py`: a sharded step equals
the single-device step on the same global batch (loss rtol 5e-4,
parameters 5e-3), here held to the port's own single-process step.

The ranks' shards are drawn so that local sums would be wrong
(`dryrun_batch(skew=True)`): the first rank's images are scaled by 10 (its
batch-norm statistics alone are far from the global ones), most of the
second rank's BEV labels are the rarest class (its class-weight sum is far
from the first's), and the pretrain model's labels are 255 on the second
rank only (its count of labels differs). Dropout is off in the compared
steps; the dropout rule (seed, step, rank) is checked on its own.

Measured (2 ranks against one process, one thread each): loss within
1.2e-5 relative (its components 5.7e-5), the gradient norm 3.3e-4, each
leaf's gradient before the clip 3.6e-2 at worst (dp2_flagship_v2, a
batch norm's bias in the last VoVNet stage; 7.8e-3 and 8.8e-3 in the
other two steps), parameters after the step 2.0e-4 (twice Adam's first
step, lr 1e-4, so this check alone cannot see a wrong gradient),
running statistics 5.8e-4 of their largest value; the evaluation's loss
equal. The one-process step with the global batch norm's arithmetic
(Chan's combination of per-rank statistics) instead of `F.batch_norm`'s
gives the sharded loss to the last bit, and its gradients differ from
`F.batch_norm`'s by 1.9e-2 themselves (1.3e-2 over the leaves of at least
a tenth of the largest norm): the differences are round-off, amplified by
random weights. The shards' own sums would move the loss by 4.4e-3
(flagship) and 2.7e-2 (pretrain model); a broken backward moves a leaf's
gradient by 0.5 or more (measured with the batch norm's backward
all-reduce removed, its bias given the weight's gradient, the replicated
gradients averaged or shifted by one element, FSDP2 averaging).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu import cli as jcli
from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.parallel.mesh import make_mesh as j_make_mesh, param_sharding
from lss2_multimodal_nu_tpu.port.torch_port import port_checkpoint_file, port_state_dict
from lss2_multimodal_nu_tpu_torch import cli
from lss2_multimodal_nu_tpu_torch import config as tconfig
from lss2_multimodal_nu_tpu_torch.data import synthetic
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.parallel import dryrun, mesh, multihost
from lss2_multimodal_nu_tpu_torch.train import checkpoint as ck, state as ts, steps as tsteps
from lss2_multimodal_nu_tpu_torch.train.steps import MODEL_INPUTS, compute_loss
from torch_dist_jobs import JOBS

WORLD = 2
B = 2  # the global batch: one sample a rank
LOSS_RTOL = 1e-4
COMPONENT_RTOL = 5e-4  # the loss's components: JAX's limit on the loss
STATE_ATOL = 5e-3  # JAX's limit on the parameters after the step
STATS_RTOL = 1e-2  # running statistics, of their largest value
GRAD_NORM_RTOL = 2e-3
GRAD_TOL = dryrun.GRAD_TOL  # a leaf's gradient, norm of difference / norm
# (name, family, LSS version, dp, fsdp): the steps compared
STEPS = (("dp2_flagship_v2", "vovnet_transformer", "v2", 2, 1),
         ("fsdp2_flagship_v1", "vovnet_transformer", "v1", 1, 2),
         ("dp2_pretrain_v1", "vovnet_pretrain", "v1", 2, 1))
EVAL_SEEDS = (1, 2)
DRYRUN_GRID = ["--xbound", *map(str, dryrun.XB), "--ybound", *map(str, dryrun.XB),
               "--final_dim", *map(str, dryrun.FINAL_DIM)]


def _resume_file(path):
    """A single-process full-state file of the v1 flagship: weights from
    `MODEL_SEED`, Adam moments from one step on random gradients."""
    cfg = dryrun.dryrun_config(lss_version="v1", batch_size=B)
    model, opt, sched = dryrun.train_setup(cfg)
    gen = torch.Generator().manual_seed(5)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    sched.step()
    ck.save_train_state(path, model, opt, sched, step=4, epoch=2)


def _local_losses(family):
    """(the train-mode loss of the global batch, the mean of the shards'
    losses each from its own statistics and normalisers), one process."""
    cfg = dryrun.dryrun_config(family, "v1", batch_size=B)
    model = tsteps.train_without_dropout(build_model(cfg, "cpu", seed=dryrun.MODEL_SEED))
    batch = dryrun.dryrun_batch(cfg, B)

    def loss(b):
        with torch.no_grad():
            return float(compute_loss(cfg, model(*(b[k] for k in MODEL_INPUTS)), b)[0])

    return loss(batch), np.mean([loss(dryrun.local_shard(batch, r, WORLD))
                                 for r in range(WORLD)])


def _jax_sharded_sizes():
    """The sizes of the flagship's (dry-run shapes, LSS v1) JAX parameters
    that `param_sharding` shards on a (4, 2) mesh of the suite's 8 CPU
    devices, their shapes from `jax.eval_shape`; and that mesh."""
    jcfg = jconfig.Config(grid=jconfig.GridConfig(xbound=dryrun.XB, ybound=dryrun.XB),
                          aug=jconfig.AugConfig(final_dim=dryrun.FINAL_DIM),
                          model=jconfig.ModelConfig(family="vovnet_transformer",
                                                    lss_version="v1"),
                          mesh=jconfig.MeshConfig(dp=4, fsdp=2))
    args = (np.zeros((1, 6, *dryrun.FINAL_DIM, 3), np.float32),
            *(np.zeros((1, 6) + s, np.float32) for s in ((3, 3), (3,), (3, 3), (3, 3), (3,))))
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0), *args)["params"]
    jmesh = j_make_mesh(jcfg)
    leaves = zip(jax.tree_util.tree_leaves(shapes),
                 jax.tree_util.tree_leaves(param_sharding(jmesh, shapes)))
    return sorted(int(np.prod(x.shape)) for x, s in leaves if "fsdp" in str(s.spec)), jmesh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks through every job, and what this process computes
    while they run: the single-process references, the skewed batch's
    local losses, JAX's sharded sizes. {"out", "refs", "eval", "local",
    "jax", "cli_dir"}."""
    out = tmp_path_factory.mktemp("ranks")
    data = tmp_path_factory.mktemp("nu")
    synthetic.generate(str(data / "mini"), samples_per_scene=2, seed=0)
    cli_dir = tmp_path_factory.mktemp("cli")
    _resume_file(str(out / "single.pth"))
    jobs = [dict(kind="train", name=name, family=family, lss_version=version, dp=dp, fsdp=fsdp,
                 b=B)
            for name, family, version, dp, fsdp in STEPS]
    jobs[1].update(kind="train_checkpoint", save="fsdp_state.pth", resume=str(out / "single.pth"),
                   resaved="resaved.pth")
    jobs += [
        dict(kind="evaluate", name="eval", dp=WORLD, fsdp=1, b=B, seeds=EVAL_SEEDS),
        dict(kind="should_stop", name="stop"),
        dict(kind="cli", name="cli", cwd=str(cli_dir), argv=[
            "pretrain-v2", "--dp", str(WORLD), "--device", "cpu", "--version", "mini",
            "--dataroot", str(data), "--H", "90", "--W", "160", *DRYRUN_GRID,
            "--bsize", str(WORLD), "--nepochs", "1", "--eval_every", "1", "--ckpt_every", "1",
            "--worker_type", "thread", "--nworkers", "1", "--log_every", "1",
            "--logdir", "logs"]),
    ]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = dryrun.spawn(WORLD, jobs, str(out), join=False, table=JOBS)
        refs = {}
        for name, family, version, _, _ in STEPS:
            cfg = dryrun.dryrun_config(family, version, batch_size=B)
            refs[name] = dryrun.single_step(cfg, dryrun.dryrun_batch(cfg, B))
        cfg = dryrun.dryrun_config(batch_size=B)
        model = build_model(cfg, "cpu", seed=dryrun.MODEL_SEED)
        evaluated = cli._evaluate(cfg, model, [dryrun.dryrun_batch(cfg, B, seed=s)
                                               for s in EVAL_SEEDS])
        local = {f: _local_losses(f) for f in ("vovnet_transformer", "vovnet_pretrain")}
        jax_sharded = _jax_sharded_sizes()
        while not ctx.join():
            pass
    finally:
        torch.set_num_threads(threads)
    return dict(out=out, refs=refs, eval=evaluated, local=local, jax=jax_sharded,
                cli_dir=cli_dir)


def _rank(ranks, name, rank):
    return dryrun.load(ranks["out"], name, rank)


# ---- the pieces without a group


def test_mesh_config_matches_jax():
    fields = lambda cls: {f.name: getattr(cls(), f.name) for f in dataclasses.fields(cls)}
    assert fields(tconfig.MeshConfig) == fields(jconfig.MeshConfig)
    assert tconfig.Config().mesh == tconfig.MeshConfig()


def test_without_a_group_the_port_is_one_process(monkeypatch):
    """No group: world 1, shard (0, 1), `initialize` joins nothing where
    WORLD_SIZE is unset or 1, and the mesh is None (one process); dp x fsdp
    other than the world exits naming WORLD_SIZE; a global batch that does
    not divide raises."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize("cpu") == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize("cpu") == (0, 1)
    assert (multihost.world(), multihost.host_shard(), multihost.is_main()) == (1, (0, 1), True)
    assert not torch.distributed.is_initialized()
    assert mesh.make_mesh(dryrun.dryrun_config(), "cpu") is None
    with pytest.raises(SystemExit, match="WORLD_SIZE=1"):
        mesh.make_mesh(dryrun.dryrun_config(dp=2), "cpu")
    assert multihost.global_batch_to_local(8, 4) == 2
    with pytest.raises(ValueError):
        multihost.global_batch_to_local(6, 4)


def test_step_seed_at_world_one_is_unchanged():
    """At world 1 the dropout stream is seeded by (seed, step), as before
    distributed runs (`test_torch_train.py` holds its masks)."""
    want = int(np.random.SeedSequence([42, 1]).generate_state(1)[0])
    assert tsteps._step_seed(42, 1) == want


def test_eval_reduce_matches_jax():
    """The port's `_eval_reduce` against the JAX CLI's
    `_multihost_eval_reduce`, each with a fake allgather of two ranks
    holding the same arrays."""
    hosts = 2
    confmat = np.asarray([[3, 1], [0, 2]], np.int64)
    acts_p = [np.ones((2, 4), bool), np.zeros((2, 4), bool)]
    descs_p = [np.ones((2, 8), bool)] * 2
    acts_t = [np.ones((2, 4), np.float32)] * 2
    descs_t = [np.zeros((2, 8), np.float32)] * 2
    want = jcli._multihost_eval_reduce(
        jax.numpy.asarray(confmat), 10.0, 4, acts_p, descs_p, acts_t, descs_t,
        allgather=lambda x: np.stack([np.asarray(x)] * hosts))
    T = lambda xs: [torch.from_numpy(x) for x in xs]
    got = cli._eval_reduce(torch.from_numpy(confmat), torch.tensor(10.0, dtype=torch.float64), 4,
                           T(acts_p), T(descs_p), T(acts_t), T(descs_t),
                           allgather=lambda t: torch.stack([t] * hosts))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (float(got[1]), got[2]) == (want[1], want[2])
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g[0].numpy(), w[0])


def test_fsdp_groups_against_jax_param_sharding(ranks):
    """Which parameters are sharded at fsdp=2, the port against JAX's
    `param_sharding` (the flagship at the dry-run shapes, LSS v1, shapes
    from `jax.eval_shape`, a (4, 2) mesh of the suite's 8 CPU devices).
    JAX shards the leaves of at least 2^19 elements (`JAX_SHARDED` by the
    port's names: JAX's rule on the port's shapes, the same sizes as JAX's
    own leaves). The port's FSDP2 groups are whole modules whose forward
    runs (`FSDP_GROUPS`), and the root group takes the rest, so the other
    210 parameters are sharded too: those are the differences (the rank's
    record at fsdp=2 in `test_fsdp_shards_every_parameter`)."""
    jax_sizes, jmesh = ranks["jax"]
    model = build_model(dryrun.dryrun_config(lss_version="v1"), "cpu")
    port = {n: jax.ShapeDtypeStruct(tuple(p.shape), np.float32)
            for n, p in model.named_parameters()}
    by_rule = [n for n, s in zip(sorted(port),
                                 jax.tree_util.tree_leaves(param_sharding(jmesh, port)))
               if "fsdp" in str(s.spec)]
    assert sorted(int(np.prod(port[n].shape)) for n in by_rule) == jax_sizes
    assert sorted(by_rule) == sorted(JAX_SHARDED)
    assert mesh.fsdp_groups(model) == FSDP_GROUPS
    assert sum(1 for _ in model.parameters()) - len(JAX_SHARDED) == 210


JAX_SHARDED = [
    *(f"backbone.backbone.stages.{s}.blocks.{b}.{leaf}.weight" for s, b, leaf in (
        (1, 0, "conv_concat.conv"), *((st, bl, lf) for st in (2, 3) for bl in (0, 1)
                                      for lf in ("conv_mid.0.conv", "conv_concat.conv",
                                                 "attn.fc")))),
    "depth_net.depth_head.0.weight", "feature_pyramid.scale1.0.weight",
    "feature_pyramid.scale2.0.weight",
    *(f"sceneunder.0.convs.{i}.0.weight" for i in (1, 2, 3)),
]
FSDP_GROUPS = ["backbone.backbone.stages.1", "backbone.backbone.stages.2",
               "backbone.backbone.stages.3", "depth_net", "feature_pyramid", "sceneunder"]


# ---- two ranks against one process


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_sharded_step_equals_single_process(ranks, name):
    """The step on two ranks' shards equals one process's on the global
    batch: loss and its components, the global gradient norm, every
    leaf's gradient (gathered in full on rank 0, within GRAD_TOL as norm of
    difference / norm; the leaves whose gradient is zero in exact
    arithmetic left out, `dryrun.grad_spread`), the parameters and the
    running statistics after the step."""
    got = _rank(ranks, name, 0)
    metrics, state, grads, skip = ranks["refs"][name]
    spread, leaf = dryrun.grad_spread(
        {k[5:]: v for k, v in got.items() if k.startswith("grad/")}, grads, skip)
    assert spread <= GRAD_TOL, (spread, leaf)
    rtols = {"metric/loss": LOSS_RTOL, "metric/grad_norm": GRAD_NORM_RTOL}
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], v, rtol=rtols.get(k, COMPONENT_RTOL), err_msg=k)
    assert np.array_equal(got["metric/loss"], _rank(ranks, name, 1)["metric/loss"])
    for k, v in state.items():
        g = got[f"state/{k}"]
        if not np.issubdtype(v.dtype, np.floating):
            np.testing.assert_array_equal(g, v, err_msg=k)
        elif "running_" in k:
            assert np.abs(g - v).max() <= STATS_RTOL * np.abs(v).max(), k
        else:
            assert np.abs(g - v).max() <= STATE_ATOL, k


def test_skewed_shards_make_local_sums_wrong(ranks):
    """The test batch is discriminating: the flagship's and the pretrain
    model's losses from each shard's own batch-norm statistics and loss
    normalisers (one process per shard) differ from the global batch's by
    more than 10 times the step's limit."""
    for family, (global_loss, local_loss) in ranks["local"].items():
        assert abs(local_loss - global_loss) > 10 * LOSS_RTOL * global_loss, family


def test_fsdp_shards_every_parameter(ranks):
    got = _rank(ranks, "fsdp2_flagship_v1", 0)
    state = ranks["refs"]["fsdp2_flagship_v1"][1]
    params = [n for n in state if not n.endswith(("running_mean", "running_var",
                                                   "num_batches_tracked"))]
    assert sorted(got["sharded"]) == sorted(params)
    assert len(_rank(ranks, "dp2_flagship_v2", 0)["sharded"]) == 0


def test_dropout_masks_follow_seed_step_and_rank(ranks):
    """At world 2 each rank seeds its dropout by (seed, step, rank): in the
    CLI's first step the seeds are those, and the first dropout's masks
    differ between ranks."""
    r0, r1 = (_rank(ranks, "cli", r) for r in range(WORLD))
    for r, got in enumerate((r0, r1)):
        want = np.random.SeedSequence([42, 0, r]).generate_state(1)[0]
        assert int(got["dropout/seed"]) == int(want)
    assert r0["dropout/mask"].shape == r1["dropout/mask"].shape
    assert not np.array_equal(r0["dropout/mask"], r1["dropout/mask"])
    assert 0.0 < r0["dropout/mask"].mean() < 1.0


def test_sharded_evaluate_equals_single_process(ranks):
    """`_evaluate` over the ranks' shards of two global batches against one
    process's over the whole batches: confusion matrix, IoUs and F1 equal,
    the loss within 1e-6."""
    want = ranks["eval"]
    for r in range(WORLD):
        got = _rank(ranks, "eval", r)
        np.testing.assert_array_equal(got["confmat"], want["confmat"])
        for k in ("iou", "mean_iou", "act_f1", "desc_f1", "act_mean", "desc_mean"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


def test_fsdp_checkpoint_is_the_single_process_file(ranks):
    """The FSDP run's full state, written by rank 0 alone, read by the
    single-process `restore_train_state` (every parameter and buffer equal
    to the gathered state) and by the JAX package's `port_checkpoint_file`."""
    r0, r1 = (_rank(ranks, "fsdp2_flagship_v1", r) for r in range(WORLD))
    assert list(r0["written"]) == ["fsdp_state.pth.tmp"] and list(r1["written"]) == []
    path = str(ranks["out"] / "fsdp_state.pth")
    cfg = dryrun.dryrun_config(lss_version="v1", batch_size=B)
    model = build_model(cfg, "cpu", seed=0).train()
    opt, sched = ts.build_optimizer(cfg, model, steps_per_epoch=dryrun.STEPS_PER_EPOCH)
    meta = ck.restore_train_state(path, model, opt, sched, map_location="cpu")
    assert (meta["step"], meta["epoch"]) == (1, 1)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, v in state.items():
        np.testing.assert_array_equal(v, r0[f"state/{k}"], err_msg=k)
    # every parameter but stage 4's at LSS v1, which gets no gradient
    assert len(opt.state) == sum(1 for n, _ in model.named_parameters()
                                 if not n.startswith("backbone.backbone.stages.3."))
    params, stats, report = port_checkpoint_file(path, "vovnet_transformer", strict=True,
                                                 lss_version="v1")
    assert report["format"] == "full_state" and not report["unmapped"]
    want_p, want_s, _ = port_state_dict("vovnet_transformer", state, lss_version="v1")
    for g, w in zip(jax.tree_util.tree_leaves((params, stats)),
                    jax.tree_util.tree_leaves((want_p, want_s))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_single_process_file_resumed_under_fsdp(ranks):
    """A single-process `state_latest.pth` restored into the FSDP model and
    optimizer (sharded) and saved again by rank 0: the same file, tensor
    for tensor, Adam's moments and step counts in torch's layout."""
    want = ck.load_file(str(ranks["out"] / "single.pth"), "cpu")
    got = ck.load_file(str(ranks["out"] / "resaved.pth"), "cpu")
    assert int(_rank(ranks, "fsdp2_flagship_v1", 0)["resumed_step"]) == 4
    assert got.keys() == want.keys()
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    go, wo = got["optimizer_state_dict"], want["optimizer_state_dict"]
    assert go["param_groups"] == wo["param_groups"] and go["state"].keys() == wo["state"].keys()
    for i, st in wo["state"].items():
        for k, v in st.items():
            assert torch.equal(go["state"][i][k], v), (i, k)
    assert got["scheduler_state_dict"] == want["scheduler_state_dict"]
    assert (got["step"], got["epoch"]) == (want["step"], want["epoch"])


def test_should_stop_is_agreed_across_ranks(ranks):
    """No signal: no rank stops; rank 1's signal alone: both stop."""
    for r in range(WORLD):
        assert list(_rank(ranks, "stop", r)["stop"]) == [False, True]


def test_cli_pretrain_v2_on_two_ranks(ranks):
    """`cli.main(["pretrain-v2", "--dp", "2", ...])` inside the group: each
    rank loads its own shard at half the global batch; rank 0 alone writes
    the text files and the checkpoints, each once; rank 1 writes nothing."""
    r0, r1 = (_rank(ranks, "cli", r) for r in range(WORLD))
    for r, got in enumerate((r0, r1)):
        assert [tuple(x) for x in got["loaders"]] == [(r, WORLD, 1)] * 2
    assert list(r1["written"]) == []
    files = {ck.STATE_LATEST, ck.BEST_PRETRAINED, ck.PRETRAINED_EPOCH.format(epoch=1)}
    # metrics.jsonl once a step (--log_every 1), result.txt once an epoch
    assert sorted(r0["written"]) == sorted(
        [f + ".tmp" for f in files] + ["result.txt"] + ["metrics.jsonl"] * 2)
    logs = ranks["cli_dir"] / "logs"
    assert sorted(os.listdir(logs)) == sorted(files | {"result.txt", "metrics.jsonl"})
    assert len((logs / "metrics.jsonl").read_text().splitlines()) == 2
