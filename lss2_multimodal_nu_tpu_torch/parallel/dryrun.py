"""A sharded train step on CPU ranks over gloo, held to the single-process
step: the port's counterpart of `__graft_entry__.py::dryrun_multichip`.

    python -m lss2_multimodal_nu_tpu_torch.parallel.dryrun [N]

`dryrun_multichip(n)` spawns n ranks on the CPU (gloo), runs one train step
of the flagship at the dry-run shapes (`__graft_entry__.py`: vovnet39, LSS
v2, a 32x32 grid, 6 cameras at 32x96) over a (n // 2, 2) mesh (n, 1 where
n is odd), its global batch of 2n samples sharded over the ranks, and
checks the loss, every leaf's gradient (gathered in full) and every
parameter after the step against one process's step on the whole batch
from the same weights. The ranks' shards are drawn
so that local statistics would differ from the global ones: the first
half's images are scaled by 10, most of the second half's BEV labels are
the rarest class.

`run_rank` is the body of every rank: it joins the group and runs a list of
jobs from a table (by default `JOBS`: the sharded step), each writing its
numpy results to `<out_dir>/<name>.rank<r>.npz` (`tests/test_torch_dist.py`
passes a table with more jobs). Dropout is off in the
compared steps (`train/steps.py::train_without_dropout`); at world > 1 the
ranks draw their own masks, so a step with dropout cannot equal one
process's.
"""
from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import multihost

XB = (-8.0, 8.0, 0.5)  # the dry-run grid: 32 x 32 BEV
FINAL_DIM = (32, 96)
MODEL_SEED = 3
RAREST_CLASS = 3  # weight 10 (`train/losses.py::BEV_CLASS_WEIGHTS`)
STEPS_PER_EPOCH = 10
GRAD_TOL = 5e-2  # a leaf's gradient, norm of difference / norm (`grad_spread`)


def dryrun_config(family: str = "vovnet_transformer", lss_version: str = "v2", dp: int = 1,
                  fsdp: int = 1, batch_size: int = 4):
    """The dry-run configuration of a family (the flagship by default)."""
    from ..config import AugConfig, Config, GridConfig, MeshConfig, ModelConfig, TrainConfig

    return Config(grid=GridConfig(xbound=XB, ybound=XB), aug=AugConfig(final_dim=FINAL_DIM),
                  model=ModelConfig(family=family, vovnet_type="vovnet39",
                                    lss_version=lss_version),
                  train=TrainConfig(batch_size=batch_size),
                  mesh=MeshConfig(dp=dp, fsdp=fsdp))


def dryrun_batch(cfg, b: int, seed: int = 0, skew: bool = True) -> Dict[str, torch.Tensor]:
    """A global batch of b samples on the CPU from a numpy seed. With
    `skew`, the first half's images are scaled by 10, most of the second
    half's BEV labels are `RAREST_CLASS`, and for the pretrain model 70% of
    the second half's labels are 255 (ignored) and none of the first's."""
    rng = np.random.default_rng(seed)
    n, (h, w) = cfg.aug.ncams, cfg.aug.final_dim
    imgs = rng.normal(size=(b, n, 3, h, w)).astype(np.float32)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)).copy()
    trans = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    intrins = np.broadcast_to(np.array([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1.0]],
                                       np.float32), (b, n, 3, 3)).copy()
    post_rots = np.broadcast_to(np.eye(3, dtype=np.float32) * (w / 1600.0), (b, n, 3, 3)).copy()
    post_rots[..., 2, 2] = 1.0
    post_trans = np.zeros((b, n, 3), np.float32)
    nx = cfg.grid.nx[0]
    binimg = rng.integers(0, cfg.model.seg_classes, size=(b, nx, nx))
    half = b // 2
    if skew:
        imgs[:half] *= 10.0
        binimg[half:] = np.where(rng.random((b - half, nx, nx)) < 0.8, RAREST_CLASS,
                                 binimg[half:])
        if cfg.model.family == "vovnet_pretrain":
            binimg[half:] = np.where(rng.random((b - half, nx, nx)) < 0.7, 255, binimg[half:])
    batch = dict(imgs=imgs, rots=rots, trans=trans, intrins=intrins, post_rots=post_rots,
                 post_trans=post_trans, binimg=binimg)
    if cfg.model.family not in ("lss", "vovnet_pretrain"):
        batch["act"] = (rng.random((b, cfg.model.num_action_classes)) < 0.4).astype(np.float32)
        batch["desc"] = (rng.random((b, cfg.model.num_desc_classes)) < 0.4).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def local_shard(batch: Dict[str, torch.Tensor], rank: int, world: int) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s contiguous share of a global batch."""
    b = next(iter(batch.values())).shape[0]
    per = multihost.global_batch_to_local(b, world)
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def train_setup(cfg, device="cpu"):
    """(model in training mode with dropout off, optimizer, scheduler) from
    `MODEL_SEED`, spread over the group's mesh of `cfg.mesh` (one process:
    no mesh)."""
    from ..models.factory import build_model
    from ..train.state import build_optimizer
    from ..train.steps import train_without_dropout
    from .mesh import make_mesh, shard_state

    model = train_without_dropout(build_model(cfg, device, seed=MODEL_SEED))
    model = shard_state(model, make_mesh(cfg, torch.device(device).type))
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    return model, opt, sched


def full_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and buffers in full, as numpy (a collective
    under FSDP2: every rank calls it)."""
    out = {}
    for k, v in model.state_dict().items():
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        out[k] = v.detach().cpu().numpy().copy()  # not a view of the live tensor
    return out


def full_grads(model: torch.nn.Module, grad_norm: Optional[float] = None,
               max_norm: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Every parameter's gradient in full, as numpy, by name; parameters
    without one are left out (a collective under FSDP2: every rank calls
    it). Given the step's `grad_norm` and the clip's `max_norm`, the
    gradients as they were before the clip, which scaled them by
    min(1, max_norm / (grad_norm + 1e-6)) (`clip_grad_norm_`): a clipped
    gradient hides its scale."""
    scale = 1.0 if grad_norm is None else min(1.0, max_norm / (grad_norm + 1e-6))
    out = {}
    for n, p in model.named_parameters():
        if p.grad is not None:
            g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad
            out[n] = (g.detach().cpu().numpy() / np.float32(scale)).astype(np.float32)
    return out


def _metrics(m: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {f"metric/{k}": v.detach().float().cpu().numpy() for k, v in m.items()}


def save(out_dir: Path, name: str, rank: int, arrays: Dict[str, np.ndarray]) -> None:
    np.savez(out_dir / f"{name}.rank{rank}.npz", **arrays)


def sharded_step(job, rank, world) -> tuple:
    """One train step of `job`'s model (family, LSS version, dp, fsdp,
    global batch b) on the rank's shard of `dryrun_batch`: (model,
    optimizer, scheduler, results), where the results hold the step's
    metrics, the names of the parameters FSDP2 shards, and on rank 0 the
    full state after the step (`state/...`) and the gradients as they were
    before the clip (`grad/...`, `full_grads`)."""
    from ..train.steps import train_step

    cfg = dryrun_config(job.get("family", "vovnet_transformer"), job.get("lss_version", "v2"),
                        job["dp"], job["fsdp"], job["b"])
    model, opt, sched = train_setup(cfg)
    batch = local_shard(dryrun_batch(cfg, job["b"]), rank, world)
    m = train_step(model, opt, sched, batch, 0)
    res = _metrics(m)
    res["sharded"] = np.array([n for n, p in model.named_parameters()
                               if hasattr(p, "placements")
                               and any(pl.is_shard() for pl in p.placements)])
    state = full_state(model)
    grads = full_grads(model, float(m["grad_norm"]), cfg.train.max_grad_norm)
    if rank == 0:
        res.update({f"state/{k}": v for k, v in state.items()})
        res.update({f"grad/{k}": v for k, v in grads.items()})
    return model, opt, sched, res


def job_train(job, rank, world, out_dir: Path) -> None:
    """`sharded_step`, its results saved."""
    save(out_dir, job["name"], rank, sharded_step(job, rank, world)[3])


JOBS = {"train": job_train}


def run_rank(rank: int, world: int, init_method: str, jobs: List[dict], out_dir: str,
             table: Optional[dict] = None) -> None:
    """One CPU rank: one torch thread, the gloo group, every job in order
    (a job's collectives meet the other ranks' in the same job). A job's
    "kind" names its function in `table` (by default `JOBS`), called as
    f(job, rank, world, out_dir)."""
    table = JOBS if table is None else table
    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=init_method, rank=rank, world_size=world)
    try:
        for job in jobs:
            table[job["kind"]](job, rank, world, Path(out_dir))
    finally:
        multihost.shutdown()


def spawn(world: int, jobs: List[dict], out_dir: str, join: bool = True,
          table: Optional[dict] = None):
    """Start `world` CPU ranks running `jobs` from `table` (`run_rank`;
    `torch.multiprocessing`'s spawn, a file store under out_dir); the
    process context, joined unless `join` is False."""
    import torch.multiprocessing as mp

    init = f"file://{os.path.join(out_dir, 'store')}"
    return mp.start_processes(run_rank, args=(world, init, jobs, out_dir, table), nprocs=world,
                              join=join, start_method="spawn")


def load(out_dir, name: str, rank: int) -> Dict[str, np.ndarray]:
    with np.load(Path(out_dir) / f"{name}.rank{rank}.npz") as f:
        return dict(f)


def single_step(cfg, batch) -> tuple:
    """One process's train step of cfg's model from `MODEL_SEED` on the
    whole batch: (metrics as numpy, full state, gradients, the model's
    `bn_fed_biases`)."""
    import dataclasses

    from ..config import MeshConfig
    from ..train.steps import train_step

    one = dataclasses.replace(cfg, mesh=MeshConfig())
    model, opt, sched = train_setup(one)
    m = train_step(model, opt, sched, batch, 0)
    grads = full_grads(model, float(m["grad_norm"]), one.train.max_grad_norm)
    return _metrics(m), full_state(model), grads, bn_fed_biases(model)


def bn_fed_biases(model: torch.nn.Module) -> set:
    """The names of the conv biases whose output goes straight into a batch
    norm (a conv child followed by a `BatchNorm2d` child). In training
    their gradient is zero in exact arithmetic, since batch norm removes
    any per-channel shift; what a step gives there is round-off of the
    batch mean, which at activations of 1e3 reaches 1e-4 of the largest
    gradient."""
    out = set()
    for name, m in model.named_modules():
        kids = list(m.named_children())
        for (a, conv), (_, bn) in zip(kids, kids[1:]):
            if (isinstance(conv, torch.nn.Conv2d) and conv.bias is not None
                    and isinstance(bn, torch.nn.BatchNorm2d)):
                out.add(f"{name}.{a}.bias" if name else f"{a}.bias")
    return out


def grad_spread(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                skip=frozenset()) -> tuple:
    """(worst norm of difference / norm, its leaf) of gradients by name;
    inf where the two name different leaves. Left out are the leaves whose
    gradient is zero in exact arithmetic, round-off on both sides: those in
    `skip` (`bn_fed_biases`) and those under 1e-6 of the largest leaf's
    norm (a conv bias that reaches a batch norm through a linear map, as
    the LSS v2 depth heads' last conv does)."""
    if sorted(got) != sorted(want):
        return float("inf"), "the leaves with gradients differ"
    norms = {n: float(np.linalg.norm(g)) for n, g in want.items()}
    top = max(norms.values())
    worst, name = 0.0, None
    for n, g in want.items():
        if n in skip or norms[n] <= 1e-6 * top:
            continue
        d = float(np.linalg.norm(got[n] - g)) / norms[n]
        if d > worst:
            worst, name = d, n
    return worst, name


def compare(got: Dict[str, np.ndarray], metrics: Dict[str, np.ndarray],
            state: Dict[str, np.ndarray], grads: Dict[str, np.ndarray], skip=frozenset()) -> dict:
    """{loss relative difference, worst parameter/buffer max abs
    difference and its name, worst gradient `grad_spread` and its leaf} of
    a sharded step's results (rank 0's) against one process's."""
    loss_rel = abs(float(got["metric/loss"]) - float(metrics["metric/loss"])) / abs(
        float(metrics["metric/loss"]))
    worst, name = 0.0, None
    for k, v in state.items():
        if not np.issubdtype(v.dtype, np.floating):
            continue
        d = float(np.abs(got[f"state/{k}"] - v).max())
        if d > worst:
            worst, name = d, k
    spread, leaf = grad_spread({k[5:]: v for k, v in got.items() if k.startswith("grad/")},
                               grads, skip)
    return {"loss_rel": loss_rel, "state_max_abs": worst, "worst": name,
            "grad_spread": spread, "worst_grad": leaf}


def dryrun_multichip(n: int = 2) -> dict:
    """The sharded flagship step on n CPU ranks against one process's step
    (the module docstring); returns the differences, raises where they pass
    the JAX package's limits (`tests/test_dist.py`: the loss 5e-4 relative,
    a parameter or buffer 5e-3) or a leaf's gradient differs by more than
    `GRAD_TOL` (norm of difference / norm)."""
    fsdp = 2 if n % 2 == 0 else 1
    dp = n // fsdp
    b = 2 * n
    with tempfile.TemporaryDirectory() as out:
        spawn(n, [dict(kind="train", name="step", dp=dp, fsdp=fsdp, b=b)], out)
        got = load(out, "step", 0)
    cfg = dryrun_config(dp=dp, fsdp=fsdp, batch_size=b)
    metrics, state, grads, skip = single_step(cfg, dryrun_batch(cfg, b))
    diff = compare(got, metrics, state, grads, skip)
    print(f"dryrun_multichip({n}): mesh ({dp}, {fsdp}), global batch {b}: loss "
          f"{float(got['metric/loss']):.9g} vs one process {float(metrics['metric/loss']):.9g} "
          f"(relative {diff['loss_rel']:.3e}); worst state max abs diff "
          f"{diff['state_max_abs']:.3e} ({diff['worst']}); worst gradient norm of difference "
          f"/ norm {diff['grad_spread']:.3e} ({diff['worst_grad']}; limit {GRAD_TOL})")
    if not (diff["loss_rel"] <= 5e-4 and diff["state_max_abs"] <= 5e-3
            and diff["grad_spread"] <= GRAD_TOL):
        raise AssertionError(f"the sharded step differs from one process's: {diff}")
    return diff


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
