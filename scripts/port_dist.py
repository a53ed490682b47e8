"""Train-v2's flagship on four cards of one host over NCCL, held to one card.

    torchrun --standalone --nproc_per_node 4 scripts/port_dist.py
    torchrun --standalone --nproc_per_node 4 scripts/port_dist.py --device cpu --small

Each process drives one card (`parallel/multihost.py`). Before the ranks
join the group, rank 0 alone runs the one-card references on its card, as
one process: nothing of the group exists yet, so the port's
single-process code runs. Then three parts, each printed by rank 0:

1. Meshes (4, 1), (2, 2) and (1, 4) at a global batch of 8 (2 a card)
   against one card's B=8 step (the same weights and batch): the flagship
   at train-v2's shapes (vovnet39, LSS v1, V3, float32, 6 cameras at
   128x352, a 200x200 grid), dropout off, a constant rate of 1e-4. The loss
   within 5e-4 relative and every parameter within 5e-3 after the step
   (the JAX package's `tests/test_dist.py` limits), and every leaf's
   gradient, gathered in full, within `dryrun.GRAD_TOL` (norm of
   difference / norm, `dryrun.grad_spread`), the one-card step run again
   printed beside as the control (on one card a step repeats bit for bit:
   its spread is 0; across cards NCCL's order of summation is not fixed).
2. Scaling: a global batch of 32 (8 a card) on the (4, 1) mesh against one
   card at B=8: step ms (host-clock median of 10 after 3), samples/s, the
   scaling efficiency (samples/s over 4 times one card's), the step's
   forward, backward and optimizer (CUDA events, medians of the same 10),
   and one profiled step of each (`torch.profiler`) split into the
   device's busy time outside NCCL kernels, the NCCL time that no other
   kernel overlaps, and idle time (the step's host-clock time less the
   union of all kernels); the NCCL kernels by name, and the post-backward
   gradient all-reduce (`parallel/mesh.py::reduce_gradients`) timed
   alone.
3. One epoch of `cli.main(["train-v2", "--dp", "4", ...])` on
   `chip_smoke.py`'s phase-10 fixture (built by rank 0 under build/), each
   rank in a working directory of its own: each rank's kernel launches and
   the files under each rank's directory (rank 0's alone).

`--device cpu --small` runs the same parts on CPU ranks over gloo at the
dry-run shapes (a rehearsal of the collectives, no timing claims). The
last line is one JSON object of the numbers; exits non-zero if a check
fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lss2_multimodal_nu_tpu_torch.parallel import multihost  # noqa: E402

LOSS_RTOL, PARAM_ATOL = 5e-4, 5e-3
MESHES = ((4, 1), (2, 2), (1, 4))


def say(*a):
    if multihost.is_main():
        print(*a, flush=True)


def config(small: bool, dp=1, fsdp=1, b=8):
    import dataclasses

    from lss2_multimodal_nu_tpu_torch.config import (Config, MeshConfig, ModelConfig,
                                                     TrainConfig)
    from lss2_multimodal_nu_tpu_torch.parallel.dryrun import dryrun_config

    train = TrainConfig(batch_size=b, lr=1e-4, weight_decay=1e-8, max_grad_norm=10.0,
                        num_epochs=60)
    if small:
        cfg = dryrun_config(lss_version="v1")
        return dataclasses.replace(cfg, train=train, mesh=MeshConfig(dp, fsdp))
    return Config(model=ModelConfig(family="vovnet_transformer", vovnet_type="vovnet39",
                                    lss_version="v1", compute_dtype="float32"),
                  train=train, mesh=MeshConfig(dp, fsdp))


def batch_for(cfg, b, device, seed=0):
    """A global batch of b samples from a numpy seed (the dry-run batch
    maker at cfg's shapes, its shards skewed), on the device."""
    from lss2_multimodal_nu_tpu_torch.parallel.dryrun import dryrun_batch

    return {k: v.to(device) for k, v in dryrun_batch(cfg, b, seed=seed).items()}


def setup(cfg, device):
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.parallel.mesh import make_mesh, shard_state
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer
    from lss2_multimodal_nu_tpu_torch.train.steps import train_without_dropout

    model = train_without_dropout(build_model(cfg, device, seed=11))
    model = shard_state(model, make_mesh(cfg, device.type))
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=1)
    return model, opt, sched


def full_params(model):
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().float().cpu()
            for n, p in model.named_parameters()}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


PARTS = ("forward", "backward", "optimizer")


def median_step_ms(model, opt, sched, batch, device, reps=10, warm=3):
    """(the host-clock median ms of a step over `reps` after `warm`, {part:
    median ms} of its forward (with the loss), backward (with the gradient
    reduction) and optimizer from CUDA events at `train_step`'s marks; no
    parts on the CPU)."""
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    ts, parts = [], {p: [] for p in PARTS}
    for i in range(warm + reps):
        sync(device)
        if multihost.world() > 1:
            dist.barrier()
        events = []
        mark = None
        if device.type == "cuda":
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()

            def mark(part):
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        t0 = time.perf_counter()
        train_step(model, opt, sched, batch, i, mark=mark)
        sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
        if i >= warm and events:
            for p, a, b in zip(PARTS, events, events[1:]):
                parts[p].append(a.elapsed_time(b))
    med = lambda xs: sorted(xs)[len(xs) // 2]
    return med(ts[warm:]), ({p: med(v) for p, v in parts.items()} if parts["forward"] else None)


def step_grads(cfg, device, batch):
    """One process's train step from the seed's weights on `batch`: (loss,
    full parameters, full gradients, the model's `bn_fed_biases`)."""
    from lss2_multimodal_nu_tpu_torch.parallel.dryrun import bn_fed_biases, full_grads
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    model, opt, sched = setup(cfg, device)
    m = train_step(model, opt, sched, batch, 0)
    out = (float(m["loss"]), full_params(model),
           full_grads(model, float(m["grad_norm"]), cfg.train.max_grad_norm), bn_fed_biases(model))
    del model, opt, sched
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def one_card(small, device):
    """Rank 0's references, before any group exists: the B=8 step and its
    control (the same step again) for part 1, and for part 2 one card's
    B=8 step timed and profiled."""
    one = config(small, b=8)
    batch = batch_for(one, 8, device)
    refs = dict(step=step_grads(one, device, batch), control=step_grads(one, device, batch))
    model, opt, sched = setup(one, device)
    b1 = batch_for(one, 8, device, seed=3)
    refs["ms"], refs["parts"] = median_step_ms(model, opt, sched, b1, device)
    if device.type == "cuda":
        refs["profile"] = step_profile(model, opt, sched, b1)
    del model, opt, sched
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return refs


def part_meshes(small, device, rank, world, refs, out):
    """Part 1: each mesh against one card's step."""
    import numpy as np

    from lss2_multimodal_nu_tpu_torch.parallel.dryrun import GRAD_TOL, full_grads, grad_spread
    from lss2_multimodal_nu_tpu_torch.parallel.dryrun import local_shard
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    b = 8
    batch = batch_for(config(small, b=b), b, device)
    ok = True
    if rank == 0:
        loss0, params0, grads0, skip = refs["step"]
        ctl = grad_spread(refs["control"][2], grads0, skip)
        ctl_w = max(float((refs["control"][1][n] - p).abs().max()) for n, p in params0.items())
        out["one_card_control"] = dict(loss=refs["control"][0], grad_spread=ctl[0],
                                       worst_grad=ctl[1], param_max_abs=ctl_w)
        say(f"1 one card B={b}: loss {loss0:.9g}; control (the same step again): loss "
            f"{refs['control'][0]:.9g}, gradients' worst norm of difference / norm {ctl[0]:.3e} "
            f"({ctl[1]}), parameters' max abs diff {ctl_w:.3e}")
    for dp, fsdp in MESHES:
        if dp * fsdp != world:
            continue
        cfg = config(small, dp, fsdp, b)
        model, opt, sched = setup(cfg, device)
        m = train_step(model, opt, sched, local_shard(batch, rank, world), 0)
        loss = float(m["loss"])
        params = full_params(model)
        grads = full_grads(model, float(m["grad_norm"]), cfg.train.max_grad_norm)
        if rank == 0:
            rel = abs(loss - loss0) / abs(loss0)
            worst, name = max((float((params[n] - p).abs().max()), n) for n, p in params0.items())
            spread, leaf = grad_spread(grads, grads0, skip)
            good = rel <= LOSS_RTOL and worst <= PARAM_ATOL and spread <= GRAD_TOL
            ok &= good
            out[f"mesh_{dp}x{fsdp}"] = dict(loss=loss, one_card_loss=loss0, loss_rel=rel,
                                            param_max_abs=worst, worst=name, grad_spread=spread,
                                            worst_grad=leaf, ok=good)
            say(f"1 mesh ({dp}, {fsdp}), global B={b}: loss {loss:.9g} against one card "
                f"{loss0:.9g} (relative {rel:.3e}, limit {LOSS_RTOL}); parameters after the "
                f"step: max abs diff {worst:.3e} ({name}; limit {PARAM_ATOL}); gradients' worst "
                f"norm of difference / norm {spread:.3e} ({leaf}; limit {GRAD_TOL}; control "
                f"{ctl[0]:.3e}): {good}")
        del model, opt, sched, params, grads
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return ok


def _union_ms(spans):
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy / 1e3


def step_profile(model, opt, sched, batch, step=100):
    """One train step under torch.profiler (CUPTI, device activity alone:
    recording the host's calls too slows each rank's launches unevenly,
    and the collectives then wait on the slowest): its host-clock ms, the
    union of its kernels' intervals (busy), that union outside NCCL's
    kernels (compute), the NCCL time no other kernel covers (busy less
    compute), idle (host-clock less busy), and NCCL's kernels by name as
    [name, count, summed ms]."""
    from torch.profiler import ProfilerActivity, profile

    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    torch.cuda.synchronize()
    if multihost.world() > 1:
        dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, sched, batch, step)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    span = lambda e: (e.time_range.start, e.time_range.end)
    busy = _union_ms([span(e) for e in kernels])
    compute = _union_ms([span(e) for e in kernels if "nccl" not in e.name.lower()])
    nccl = {}
    for e in kernels:
        if "nccl" in e.name.lower():
            c, t = nccl.get(e.name[:60], (0, 0.0))
            nccl[e.name[:60]] = (c + 1, t + (e.time_range.end - e.time_range.start) / 1e3)
    return dict(wall_ms=wall, busy_ms=busy, compute_ms=compute, exposed_nccl_ms=busy - compute,
                idle_ms=wall - busy, nccl=[[k, c, t] for k, (c, t) in sorted(nccl.items())])


def reduce_ms(model, device, reps=5):
    """The median ms of `reduce_gradients` alone over the step's gradients
    (CUDA events on rank 0's stream, every rank calling)."""
    from lss2_multimodal_nu_tpu_torch.parallel.mesh import reduce_gradients

    ts = []
    for _ in range(reps):
        dist.barrier()
        sync(device)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        reduce_gradients(model)
        b.record()
        sync(device)
        ts.append(a.elapsed_time(b))
    return sorted(ts)[reps // 2]


def part_scaling(small, device, rank, world, refs, out):
    """Part 2: global B=32 on (world, 1) against one card at B=8."""
    from lss2_multimodal_nu_tpu_torch.parallel.dryrun import local_shard

    per = 8
    cfg = config(small, world, 1, per * world)
    model, opt, sched = setup(cfg, device)
    batch = local_shard(batch_for(cfg, per * world, device, seed=4), rank, world)
    ms, parts = median_step_ms(model, opt, sched, batch, device)
    prof = reduce = None
    if device.type == "cuda":
        prof = step_profile(model, opt, sched, batch)
        reduce = reduce_ms(model, device)
    if rank == 0:
        one_ms = refs["ms"]
        sps1, sps = per / one_ms * 1e3, per * world / ms * 1e3
        out["scaling"] = dict(one_card_ms=one_ms, one_card_samples_s=sps1, ms=ms,
                              samples_s=sps, efficiency=sps / (world * sps1),
                              parts=parts, one_card_parts=refs["parts"],
                              profile=prof, one_card_profile=refs.get("profile"),
                              reduce_gradients_ms=reduce)
        say(f"2 global B={per * world} on ({world}, 1): {ms:.3f} ms a step ({sps:.2f} samples/s) "
            f"against one card at B={per} {one_ms:.3f} ms ({sps1:.2f} samples/s): scaling "
            f"efficiency {sps / (world * sps1):.3f}")
        if parts:
            one = refs["parts"]
            say("2 the step's parts (CUDA events, medians): " + "; ".join(
                f"{p} {one[p]:.3f} ms on one card, {parts[p]:.3f} on rank 0 of {world} "
                f"({parts[p] - one[p]:+.3f})" for p in PARTS))
        if prof:
            one = refs["profile"]
            for label, p in (("one card", one), (f"rank 0 of {world}", prof)):
                say(f"2 profiled step, {label}: {p['wall_ms']:.3f} ms host clock; device busy "
                    f"{p['busy_ms']:.3f} ms, of it outside NCCL {p['compute_ms']:.3f}, NCCL "
                    f"alone {p['exposed_nccl_ms']:.3f}; idle {p['idle_ms']:.3f}")
            say(f"2 the gap {prof['wall_ms'] - one['wall_ms']:+.3f} ms (profiled): compute "
                f"{prof['compute_ms'] - one['compute_ms']:+.3f}, NCCL alone "
                f"{prof['exposed_nccl_ms'] - one['exposed_nccl_ms']:+.3f}, idle "
                f"{prof['idle_ms'] - one['idle_ms']:+.3f}; NCCL kernels "
                f"{json.dumps(prof['nccl'])}; reduce_gradients alone {reduce:.3f} ms")
    del model, opt, sched


def part_cli(small, device, rank, world, out):
    """Part 3: one train-v2 epoch through the CLI at --dp world, each rank
    in a working directory of its own."""
    import chip_smoke as cs
    from lss2_multimodal_nu_tpu_torch import cli

    base = ROOT / "build" / "dist_cli"
    data = base / "data" / "mini"
    if rank == 0:
        shutil.rmtree(base, ignore_errors=True)
        if small:
            from lss2_multimodal_nu_tpu_torch.data import synthetic

            synthetic.generate(str(data), samples_per_scene=4, seed=0)
        else:
            cs.data_fixture(data)
    dist.barrier()
    wrappers = cs.port_wrappers()
    for f in wrappers.values():
        f.launches = 0
    work = base / f"rank{rank}"
    work.mkdir(parents=True, exist_ok=True)
    argv = ["train-v2", "--dp", str(world), "--device", device.type, "--version", "mini",
            "--dataroot", str(data.parent), "--nepochs", "1", "--eval_every", "1",
            "--worker_type", "thread", "--no_pretrained", "--logdir", "logs"]
    if small:
        argv += ["--H", "90", "--W", "160", "--bsize", str(world), "--xbound", "-8", "8", "0.5",
                 "--ybound", "-8", "8", "0.5", "--final_dim", "32", "96"]
    cwd = os.getcwd()
    os.chdir(work)
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in wrappers.items()}
    written = sorted(str(p.relative_to(work)) for p in work.rglob("*") if p.is_file())
    every = [None] * world
    dist.all_gather_object(every, dict(launches=launches, written=written))
    ok = True
    if rank == 0:
        out["cli"] = dict(wall_s=wall, ranks=every)
        for r, got in enumerate(every):
            say(f"3 train-v2 --dp {world}, rank {r}: launches {json.dumps(got['launches'])}; "
                f"files in its directory {got['written']}")
        needed = ("deformable_sample", "deformable_sample_backward", "lift_splat",
                  "lift_splat_backward")
        # on the CPU the wrappers run their plain versions: no launch
        ok = (all(not got["written"] for got in every[1:]) and bool(every[0]["written"])
              and (device.type != "cuda"
                   or all(got["launches"][n] > 0 for got in every for n in needed)))
        say(f"3 one epoch in {wall:.1f} s; files by rank 0 alone, every rank launching kernels "
            f"1, 2, 3 and 3b: {ok}")
    dist.barrier()
    if rank == 0:
        shutil.rmtree(base, ignore_errors=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="the dry-run shapes")
    ap.add_argument("--parts", default="123")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        print("run under torchrun with more than one process")
        return 2
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    refs = {}
    if int(os.environ.get("RANK", "0")) == 0:
        if cuda:
            from lss2_multimodal_nu_tpu_torch.ops import _build

            _build.build_all()
        if "1" in args.parts or "2" in args.parts:
            t0 = time.perf_counter()
            refs = one_card(args.small, device)
            print(f"one-card references before the group: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    rank, world = multihost.initialize(args.device)
    if cuda:
        import subprocess

        from lss2_multimodal_nu_tpu_torch.ops import _build

        _build.build_all()  # built by rank 0 before it joined
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        say("cards:", smi.stdout.strip().replace("\n", " | "))
    say(f"torch {torch.__version__}, {world} ranks, backend {dist.get_backend()}")
    out = {"world": world}
    ok = True
    try:
        if "1" in args.parts:
            ok &= part_meshes(args.small, device, rank, world, refs, out)
        if "2" in args.parts:
            part_scaling(args.small, device, rank, world, refs, out)
        if "3" in args.parts:
            ok &= part_cli(args.small, device, rank, world, out)
    finally:
        say(json.dumps(out))
        multihost.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
