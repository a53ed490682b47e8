"""The jobs that `tests/test_torch_dist.py` runs on its gloo ranks, beside the
port's own `train` job (`lss2_multimodal_nu_tpu_torch/parallel/dryrun.py`).

The ranks are spawned processes that import this module to find the jobs,
so it imports neither JAX nor a test module. Each job is called as
f(job, rank, world, out_dir) and writes its numpy results to
`<out_dir>/<name>.rank<r>.npz` (`dryrun.save`).
"""
import builtins
import os
import unittest.mock as mock
from pathlib import Path
from typing import List

import numpy as np
import torch

from lss2_multimodal_nu_tpu_torch.parallel import dryrun


def _writes():
    """(a list, two patches): under the patches, the base name of every
    path this process writes through `torch.save` or `open` in a writing
    mode is appended to the list."""
    paths: List[str] = []
    save, opener = torch.save, builtins.open

    def recording_save(obj, f, *a, **k):
        paths.append(os.path.basename(str(f)))
        return save(obj, f, *a, **k)

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax"):
            paths.append(os.path.basename(str(file)))
        return opener(file, mode, *a, **k)

    return paths, [mock.patch.object(torch, "save", recording_save),
                   mock.patch.object(builtins, "open", recording_open)]


def job_train_checkpoint(job, rank, world, out_dir: Path) -> None:
    """`dryrun.sharded_step`, then `save_train_state` to `job["save"]` under
    out_dir (the files each rank wrote recorded), then the single-process
    full-state file `job["resume"]` restored into the model and optimizer
    and saved again as `job["resaved"]`."""
    from lss2_multimodal_nu_tpu_torch.train import checkpoint as ckpt

    model, opt, sched, res = dryrun.sharded_step(job, rank, world)
    paths, patches = _writes()
    with patches[0], patches[1]:
        ckpt.save_train_state(str(out_dir / job["save"]), model, opt, sched, step=1, epoch=1)
    res["written"] = np.array(paths, dtype=str)
    meta = ckpt.restore_train_state(job["resume"], model, opt, sched, map_location="cpu")
    ckpt.save_train_state(str(out_dir / job["resaved"]), model, opt, sched,
                          step=meta["step"], epoch=meta["epoch"])
    res["resumed_step"] = np.array(meta["step"])
    dryrun.save(out_dir, job["name"], rank, res)


def job_evaluate(job, rank, world, out_dir: Path) -> None:
    """`cli._evaluate` of the flagship over the rank's shards of
    `job["seeds"]`' global batches."""
    from lss2_multimodal_nu_tpu_torch.cli import _evaluate
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.parallel.mesh import make_mesh, shard_state

    cfg = dryrun.dryrun_config(dp=job["dp"], fsdp=job["fsdp"], batch_size=job["b"])
    model = shard_state(build_model(cfg, "cpu", seed=dryrun.MODEL_SEED), make_mesh(cfg, "cpu"))
    loader = [dryrun.local_shard(dryrun.dryrun_batch(cfg, job["b"], seed=s), rank, world)
              for s in job["seeds"]]
    info = _evaluate(cfg, model, loader)
    dryrun.save(out_dir, job["name"], rank, {k: np.asarray(info[k]) for k in (
        "loss", "confmat", "iou", "mean_iou", "act_f1", "desc_f1", "act_mean", "desc_mean")})


def job_should_stop(job, rank, world, out_dir: Path) -> None:
    """`PreemptionHandler.should_stop()` with no signal, then with rank 1's
    flag set alone."""
    from lss2_multimodal_nu_tpu_torch.train.checkpoint import PreemptionHandler

    handler = PreemptionHandler()
    try:
        before = handler.should_stop()
        if rank == 1:
            handler._flag.set()
        after = handler.should_stop()
    finally:
        handler.close()
    dryrun.save(out_dir, job["name"], rank, {"stop": np.array([before, after])})


def job_cli(job, rank, world, out_dir: Path) -> None:
    """`cli.main(job["argv"])` in `job["cwd"]`, recording the files this
    rank wrote, the host shard and batch size of each loader, and the
    first training dropout's kept mask with the first step's dropout seed
    (the CLI's default seed, 42)."""
    from lss2_multimodal_nu_tpu_torch import cli
    from lss2_multimodal_nu_tpu_torch.train.steps import _step_seed

    loaders, masks = [], []

    def dropout_hook(mod, args, out):
        if isinstance(mod, torch.nn.Dropout) and mod.training and not masks:
            masks.append((out != 0).numpy())

    make = cli._loaders

    def recording_loaders(*a, **k):
        out = make(*a, **k)
        for dl in (out if isinstance(out, tuple) else (out,)):
            loaders.append((dl.host_index, dl.host_count, dl.batch_size))
        return out

    paths, patches = _writes()
    cwd = os.getcwd()
    os.chdir(job["cwd"])
    hook = torch.nn.modules.module.register_module_forward_hook(dropout_hook)
    try:
        with patches[0], patches[1], mock.patch.object(cli, "_loaders", recording_loaders):
            cli.main(job["argv"])
    finally:
        hook.remove()
        os.chdir(cwd)
    dryrun.save(out_dir, job["name"], rank, {
        "written": np.array(paths, dtype=str), "loaders": np.array(loaders),
        "dropout/mask": masks[0], "dropout/seed": np.array(_step_seed(42, 0), dtype=np.uint64)})


JOBS = {**dryrun.JOBS, "train_checkpoint": job_train_checkpoint, "evaluate": job_evaluate,
        "should_stop": job_should_stop, "cli": job_cli}
