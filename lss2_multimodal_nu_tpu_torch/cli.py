"""Command-line entry point: `python -m lss2_multimodal_nu_tpu_torch.cli <cmd>`.

The JAX package's `cli.py` in PyTorch, with its subcommands, flags,
defaults and output files, for the original repo's five scripts:

  pretrain      stage 1 of Stack A (LSS), BEV only
  train         stage 2 of Stack A (BevTxt), BEV and the TXT heads
  train-onlybev BevTxt's BEV-only ablation
  pretrain-v2   stage 1 of Stack B (VoVNetPreTrain)
  train-v2      Stack B (VoVNetBEVTransformer, ablations V1/V2/V3), warm
                started from pretrain-v2's best components by default
  predict       BevTxt on the test split (test.txt)
  predict-iou   LSS's BEV IoU on the val split (b1_20.txt)

One flag is the port's own: `--device` (default `cuda`), where the JAX
package reads `JAX_PLATFORMS`. With `cuda` and no card the command exits;
`--device cpu` runs everything, kernels included, in plain PyTorch.
Checkpoints are the original repo's `.pt` files (`train/checkpoint.py`),
where the JAX package writes Orbax directories; `scripts/jax_checkpoint_to_pt.py`
converts the JAX package's. The JAX CLI's `port` subcommand (torch -> Orbax)
has no counterpart here: the port reads `.pt` files itself.

On more than one device, one process a device under torchrun:

  torchrun --nproc_per_node N -m lss2_multimodal_nu_tpu_torch.cli train-v2 --dp N ...

`--dp` x `--fsdp` must equal the number of processes (`parallel/mesh.py`:
replicated where --fsdp is 1, FSDP2 where it is larger). `--bsize` is the
step's global batch, as in the JAX CLI on one host, whose devices share
it: each rank loads `--bsize // world` samples of it (the command exits
where that does not divide) from its own shard of the split, so the rate,
the schedule, the steps per epoch and the checkpoints mean what a one-card
run with the same flags means. Batch norm, the losses and the evaluation's
metrics are the global batch's; rank 0 alone prints and writes files.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .parallel import multihost


def _build_cfg(args, family: str):
    from .config import AugConfig, Config, GridConfig, MeshConfig, ModelConfig, TrainConfig

    grid = GridConfig(
        xbound=tuple(args.xbound), ybound=tuple(args.ybound),
        zbound=tuple(args.zbound), dbound=tuple(args.dbound),
    )
    aug = AugConfig(
        H=args.H, W=args.W, final_dim=tuple(args.final_dim),
        resize_lim=tuple(args.resize_lim), bot_pct_lim=tuple(args.bot_pct_lim),
        rot_lim=tuple(args.rot_lim), rand_flip=args.rand_flip, ncams=args.ncams,
    )
    model = ModelConfig(
        family=family, seg_classes=args.seg_classes,
        effnet_variant=args.effnet_variant, vovnet_type=args.vovnet_type,
        lss_version=args.lss_version,
        use_camera_attn=args.version_flags in ("V2", "V3"),
        use_cross_attn=args.version_flags == "V3",
        compute_dtype=args.dtype,
    )
    train = TrainConfig(
        batch_size=args.bsize, lr=args.lr, weight_decay=args.wdecay,
        max_grad_norm=args.max_grad_norm, num_epochs=args.nepochs,
        use_schedule=(family in ("vovnet_transformer", "vovnet_pretrain") and args.use_schedule),
        warmup_epochs=getattr(args, "warmup_epochs", 5),
        seed=args.seed,
        # only the wandb logger reads the summaries
        watch_gradients=getattr(args, "wandb_watch", False) and getattr(args, "wandb", False),
    )
    # train-v2's --save_suffix appends to the log directory
    logdir = args.logdir + getattr(args, "save_suffix", "")
    return Config(grid=grid, aug=aug, model=model, train=train,
                  mesh=MeshConfig(dp=args.dp, fsdp=args.fsdp),
                  dataroot=args.dataroot, version=args.version, logdir=logdir)


def _say(*args) -> None:
    """print, on rank 0 alone."""
    if multihost.is_main():
        print(*args)


def _append(path: str, text: str) -> None:
    """Append text to a file, on rank 0 alone."""
    if multihost.is_main():
        with open(path, "a") as f:
            f.write(text)


def _device(args) -> torch.device:
    """`--device`, after joining the process group where torchrun started
    more than one process (NCCL on cards, each process on its
    `LOCAL_RANK`'s; gloo on the CPU). On a card, every kernel is built
    here, before the loader's workers start (each would otherwise build
    them itself), by rank 0 first: the other ranks then find them built."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(--device cpu runs on the CPU)")
    multihost.initialize(device.type)
    if device.type == "cuda":
        from .ops import _build

        device = torch.device("cuda", torch.cuda.current_device())
        if multihost.is_main():
            _build.build_all()
        if multihost.world() > 1:
            torch.distributed.barrier()
        _build.build_all()
    return device


def _mesh(cfg, device):
    """The run's (dp, fsdp) mesh (None for one process), after checking
    that the global batch divides over the ranks."""
    from .parallel.mesh import make_mesh

    mesh = make_mesh(cfg, device.type)
    world = multihost.world()
    if cfg.train.batch_size % world:
        raise SystemExit(f"--bsize {cfg.train.batch_size} is the global batch and must divide "
                         f"over the {world} processes")
    return mesh


def _loaders(cfg, with_txt: bool, split_family: str, test: bool = False, nworkers: int = 8,
             nondet_aug: bool = False, worker_type: str = "thread",
             host_shard: tuple = (0, 1), device="cuda"):
    """(train, val) loaders, or with `test` the test split's (mini_val for
    the mini version), their batches on `device`."""
    from .data.dataset import NuA2DDataset
    from .data.loader import DataLoader
    from .data.nuscenes_index import NuScenesIndex

    dataroot = os.path.join(cfg.dataroot, cfg.version)
    nusc = NuScenesIndex(f"v1.0-{cfg.version}", dataroot)
    common = dict(aug=cfg.aug, grid=cfg.grid, data_root=dataroot,
                  split_family=split_family, with_txt=with_txt, device=device)
    lcommon = dict(num_workers=nworkers, worker_type=worker_type, host_shard=host_shard)
    # each rank's share of the global batch
    bsize = multihost.global_batch_to_local(cfg.train.batch_size, host_shard[1])
    if test:
        split = "test" if cfg.version == "trainval" else "mini_val"
        ds = NuA2DDataset(nusc, is_train=False, split=split, **common)
        return DataLoader(ds, bsize, shuffle=False, drop_last=True, **lcommon)
    tr = NuA2DDataset(nusc, is_train=True,
                      rng=None if nondet_aug else np.random.default_rng(cfg.train.seed),
                      **common)
    va = NuA2DDataset(nusc, is_train=False, **common)
    return (
        DataLoader(tr, bsize, shuffle=True, drop_last=True, **lcommon),
        DataLoader(va, bsize, shuffle=False, drop_last=True, **lcommon),
    )


def _evaluate(cfg, model, loader, no_bev: bool = False) -> dict:
    """The original repo's validation: the mean loss, the BEV confusion
    matrix with its IoUs (left out with `no_bev`), and for the multitask
    families the act/desc F1 scores. The model runs in eval mode and is put
    back in the mode it was in. The sums and predictions stay on the
    device; the host reads them once, at the end. In a group, each rank
    evaluates its shard of every batch and `_eval_reduce` assembles the
    global metrics before that read (in a group of one too: the same
    numbers, bit for bit)."""
    from .train.metrics import confusion_matrix_compute, format_confusion, per_class_and_macro_f1
    from .train.steps import eval_step

    n = cfg.model.seg_classes
    device = next(model.parameters()).device
    confmat = torch.zeros((n, n), dtype=torch.int64, device=device)
    total_loss = torch.zeros((), dtype=torch.float32, device=device)
    total_n = 0
    world = multihost.world()
    acts_t, acts_p, descs_t, descs_p = [], [], [], []
    was_training = model.training
    model.eval()
    try:
        for batch in loader:
            res = eval_step(model, batch, confmat)
            confmat = res["confmat"]
            bs = res["bsize"]  # from the shape: no sync
            # in a group the loss is this rank's share of the global batch's
            total_loss = total_loss + res["loss"].float() * (bs * world)
            total_n += bs
            if "act_pred" in res:
                acts_p.append(res["act_pred"])
                descs_p.append(res["desc_pred"])
                acts_t.append(batch["act"])
                descs_t.append(batch["desc"])
    finally:
        model.train(was_training)
    if multihost.joined():
        confmat, total_loss, total_n, acts_p, descs_p, acts_t, descs_t = _eval_reduce(
            confmat, total_loss, total_n, acts_p, descs_p, acts_t, descs_t)
    if total_n == 0:
        _say("[eval] WARNING: no evaluation batches (val set smaller than the "
              "batch size with drop_last=True) — metrics will be NaN")
    # one copy to the host: the loss sum, the counts and the 0/1 labels are
    # exact in float64
    parts = [total_loss.reshape(1), confmat.reshape(-1)]
    if acts_p:
        parts += [torch.cat(t).reshape(-1) for t in (acts_t, acts_p, descs_t, descs_p)]
    host = torch.cat([p.double() for p in parts]).cpu().numpy()
    out = {"loss": float(host[0]) / max(total_n, 1)}
    if not no_bev:
        out["confmat"] = host[1:1 + n * n].astype(np.int64).reshape(n, n)
        out.update(confusion_matrix_compute(out["confmat"]))
        out["confmat_str"] = format_confusion(out["confmat"])
    if acts_p:
        rest = host[1 + n * n:]
        na, nd = acts_p[0].shape[1], descs_p[0].shape[1]
        sizes = [total_n * na] * 2 + [total_n * nd] * 2
        a_t, a_p, d_t, d_p = np.split(rest, np.cumsum(sizes)[:-1])
        act_per, act_overall, act_mean = per_class_and_macro_f1(
            a_t.reshape(-1, na), a_p.reshape(-1, na))
        desc_per, desc_overall, desc_mean = per_class_and_macro_f1(
            d_t.reshape(-1, nd), d_p.reshape(-1, nd))
        out.update(
            act_f1=act_per.tolist(), desc_f1=desc_per.tolist(),
            act_overall=act_overall, desc_overall=desc_overall,
            act_mean=act_mean, desc_mean=desc_mean,
        )
    return out


def _allgather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's t stacked along a new leading axis, in rank order."""
    return multihost.all_gather_cat(t[None])


def _eval_reduce(confmat, total_loss, total_n, acts_p, descs_p, acts_t, descs_t,
                 allgather=None):
    """The global evaluation from the ranks' shards, as the JAX CLI's
    `_multihost_eval_reduce` assembles it (the original repo's
    `ConfusionMatrix.reduce_from_all_processes`): the confusion matrices
    and the loss sums summed, the counts summed (every rank evaluates the
    same number of samples: the loader gives each n // world and drops the
    last batch), the act/desc predictions and targets concatenated in rank
    order. Everything stays on the device. `allgather` (each rank's tensor
    stacked on a new leading axis) is injectable for tests."""
    allgather = allgather or _allgather
    confmat = allgather(confmat).sum(0)
    total_loss = allgather(total_loss.reshape(())).sum(0)
    total_n *= allgather(torch.ones((), device=confmat.device)).shape[0]

    def gather_cat(chunks):
        local = torch.cat(chunks)
        return [allgather(local).reshape((-1,) + local.shape[1:])]

    if acts_p:
        acts_p, descs_p = gather_cat(acts_p), gather_cat(descs_p)
        acts_t, descs_t = gather_cat(acts_t), gather_cat(descs_t)
    return confmat, total_loss, total_n, acts_p, descs_p, acts_t, descs_t


def _print_restore(report: dict) -> None:
    _say(f"  format {report['format']}: loaded {report['loaded']}")
    for comp, reason in report["dropped"].items():
        _say(f"  dropped {comp}: {reason}")
    if report["absent"]:
        _say(f"  not in the file, left at init: {report['absent']}")
    if report["unexpected"]:
        _say(f"  not in the model, ignored: {report['unexpected']}")


def _maybe_stage1_warmstart(args, family: str, model, device, restored: bool) -> None:
    """train-v2's default warm start from pretrain-v2's best components
    (`--pretrained_path`): backbone, depth_net, cam_encode and bev_encoder,
    each loaded whole or, if it does not fit (an LSS v2 file into a v1
    flagship: depth_net), dropped whole. Not when --checkpoint was given,
    --resume restored a file, or --no_pretrained; a missing file leaves the
    random init, with a warning."""
    from .train import checkpoint as ckpt

    if (family != "vovnet_transformer" or args.checkpoint or restored
            or getattr(args, "no_pretrained", False)):
        return
    pp = getattr(args, "pretrained_path", "")
    if pp and os.path.exists(pp):
        _say(f"Loading pre-trained weights from: {pp}")
        _print_restore(ckpt.restore_loose(pp, model, map_location=device))
    elif pp:
        _say(f"Pre-trained weights not found at {pp}")
        _say("  Training from random/ImageNet init only")


def run_training(args, family: str, with_txt: bool, split_family: str):
    """Train `family` for --nepochs epochs, validating every --eval_every
    (Stack B counts epochs from 1, Stack A from 0) and saving as the JAX CLI
    does; returns the model, in training mode."""
    from .models.factory import build_model
    from .models.vovnet_pretrain import PRETRAIN_COMPONENTS
    from .parallel.mesh import shard_state
    from .train import checkpoint as ckpt
    from .train.state import build_optimizer
    from .train.steps import train_step

    cfg = _build_cfg(args, family)
    device = _device(args)
    mesh = _mesh(cfg, device)
    os.makedirs(cfg.logdir, exist_ok=True)
    trainloader, valloader = _loaders(cfg, with_txt, split_family, nworkers=args.nworkers,
                                      nondet_aug=args.nondeterministic_aug,
                                      worker_type=args.worker_type,
                                      host_shard=multihost.host_shard(), device=device)
    # as in the JAX CLI, whose probe for the model's input shapes starts the
    # loader's first epoch: training then sees its batches in its order
    if next(iter(trainloader), None) is None:
        raise SystemExit(
            f"no training batches: {len(trainloader.dataset)} samples with "
            f"batch_size={cfg.train.batch_size} and drop_last=True"
        )
    model = shard_state(build_model(cfg, device, seed=cfg.train.seed).train(), mesh)
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=len(trainloader))
    step = 0  # the next train step's index: its dropout seed
    restored = False
    if args.checkpoint:
        _say("loading", args.checkpoint)
        _print_restore(ckpt.restore_loose(args.checkpoint, model, map_location=device))
    elif args.resume:
        latest = os.path.join(cfg.logdir, ckpt.STATE_LATEST)
        if os.path.isfile(latest):
            _say("resuming from", latest)
            step = ckpt.restore_train_state(latest, model, opt, sched, map_location=device)["step"]
            restored = True
        else:
            pl = ckpt.latest_checkpoint(cfg.logdir)
            if pl:  # the weights alone, no optimizer state
                _say("warm-starting params from", pl)
                _print_restore(ckpt.restore_loose(pl, model, map_location=device))
                restored = True
    _maybe_stage1_warmstart(args, family, model, device, restored)

    counter = 0
    preempt = ckpt.PreemptionHandler()
    results_txt = os.path.join(cfg.logdir, args.results_file)
    metrics_jsonl = os.path.join(cfg.logdir, "metrics.jsonl")
    logger = None
    if args.wandb and multihost.is_main():
        from .utils.logging import MetricLogger

        logger = MetricLogger(
            cfg.logdir, run_name=args.wandb_project, use_wandb=True,
            wandb_config={"family": family, **dataclasses.asdict(cfg.train),
                          **dataclasses.asdict(cfg.model)},
            wandb_name=getattr(args, "run_name", "") or None,
        )
    best_miou, best_epoch = -1.0, -1
    # Stack B counts epochs from 1 for its validate / save cadences; Stack
    # A validates and saves every epoch, model0.pt first
    stack_b = family in ("vovnet_pretrain", "vovnet_transformer")
    try:
        for epoch in range(cfg.train.num_epochs):
            ep = epoch + 1 if stack_b else epoch
            _say(f"--------------Epoch: {ep}--------------")
            t_ep = time.time()
            for batch in trainloader:
                metrics = train_step(model, opt, sched, batch, step)
                step += 1
                counter += 1
                if counter % args.log_every == 0:
                    loss = float(metrics["loss"])
                    _say(f"Counter{counter} Train_Loss: {loss}")
                    _append(metrics_jsonl, json.dumps({"step": counter, "loss": loss}) + "\n")
                    if logger:
                        row = {"train/loss": loss}
                        if args.wandb_watch:
                            for k, v in metrics.items():
                                if k.startswith("grad_norm/"):
                                    row[f"gradients/{k.split('/', 1)[1]}_norm"] = float(v)
                                elif k.startswith("grad_sample/"):
                                    row[f"gradients/{k.split('/', 1)[1]}"] = v.cpu().numpy()
                        logger.log(counter, row)
            if ep % max(args.eval_every, 1) == 0:
                info = _evaluate(cfg, model, valloader)
                _say(info["confmat_str"])
                if "act_overall" in info:
                    ad_info = """
                F1_Action: {0}
                F1_Description: {1}
                Action_overall: {2}
                Description_overall: {3}
                Action_mean: {4}
                Description_mean: {5}
                """.format(
                        info["act_f1"], info["desc_f1"], info["act_overall"],
                        info["desc_overall"], info["act_mean"], info["desc_mean"],
                    )
                    _append(results_txt, f"epoch{ep}" + info["confmat_str"] + "\n"
                            + "F1_info: " + ad_info + "\n\n")
                else:
                    _append(results_txt, f"epoch{ep}" + info["confmat_str"] + "\n"
                            + "val_loss: " + str(info["loss"]) + "\n\n")
                if logger:
                    logger.log(counter, {
                        "epoch": ep, "val/loss": info["loss"],
                        "val/bev_miou": float(info.get("mean_iou", float("nan"))),
                        **({"val/action_f1": info["act_mean"],
                            "val/desc_f1": info["desc_mean"]}
                           if "act_mean" in info else {}),
                    })
                miou = float(info.get("mean_iou", float("nan")))
                if args.save_best and miou == miou and miou > best_miou:
                    best_miou, best_epoch = miou, ep
                    if family == "vovnet_pretrain":
                        # the best components, stage 2's warm start
                        bname = os.path.join(cfg.logdir, ckpt.BEST_PRETRAINED)
                        ckpt.save_components(bname, model, PRETRAIN_COMPONENTS, epoch=ep,
                                             miou=best_miou, lss_version=cfg.model.lss_version)
                    else:
                        bname = os.path.join(
                            cfg.logdir, ckpt.BEST_MODEL.format(flags=args.version_flags))
                        ckpt.save_train_state(bname, model, opt, sched, step=step, epoch=ep,
                                              best_miou=best_miou)
                    _say(f"saved best model: {bname} (mIoU: {best_miou:.4f})")
            if not stack_b:
                mname = os.path.join(cfg.logdir, ckpt.MODEL_FILE.format(epoch=ep))
                _say("saving", mname)
                ckpt.save_params(mname, model)
            # everything resume needs, overwritten each epoch
            ckpt.save_train_state(os.path.join(cfg.logdir, ckpt.STATE_LATEST), model, opt, sched,
                                  step=step, epoch=ep)
            if args.ckpt_every and ep % args.ckpt_every == 0:
                if family == "vovnet_pretrain":
                    ckpt.save_components(
                        os.path.join(cfg.logdir, ckpt.PRETRAINED_EPOCH.format(epoch=ep)), model,
                        PRETRAIN_COMPONENTS, epoch=ep, lss_version=cfg.model.lss_version)
                else:
                    ckpt.save_train_state(
                        os.path.join(cfg.logdir, ckpt.CHECKPOINT_EPOCH.format(
                            flags=args.version_flags, epoch=ep)),
                        model, opt, sched, step=step, epoch=ep)
            if preempt.should_stop():
                _say("preemption signal received — saved, exiting cleanly")
                return model
            _say(f"epoch time: {time.time() - t_ep:.1f}s")
        if args.save_best and best_epoch >= 0:
            _say(f"Best mIoU: {best_miou:.4f} at epoch {best_epoch}")
            if logger and logger._wandb:
                logger._wandb.run.summary["best_miou"] = best_miou
                logger._wandb.run.summary["best_epoch"] = best_epoch
    finally:
        preempt.close()
        if logger:
            logger.close()
    return model


def _predict_model(args, cfg, device, mesh):
    """The family's model (weights from seed 0, as the JAX CLI's init) in
    eval mode, warm-started from --checkpoint, spread over the mesh."""
    from .models.factory import build_model
    from .parallel.mesh import shard_state
    from .train import checkpoint as ckpt

    model = build_model(cfg, device, seed=0)
    if args.checkpoint:
        _say("loading", args.checkpoint)
        _print_restore(ckpt.restore_loose(args.checkpoint, model, map_location=device))
    return shard_state(model, mesh)


def run_predict_iou(args) -> dict:
    """LSS's BEV evaluation of --checkpoint on the val split, appended to
    --out_file."""
    cfg = _build_cfg(args, "lss")
    device = _device(args)
    mesh = _mesh(cfg, device)
    _, valloader = _loaders(cfg, with_txt=False, split_family="nuscenes_full",
                            nworkers=args.nworkers, host_shard=multihost.host_shard(),
                            device=device)
    model = _predict_model(args, cfg, device, mesh)
    info = _evaluate(cfg, model, valloader)
    _say(info["confmat_str"])
    _say("val_loss: {}".format(info["loss"]))
    _append(args.out_file, "checkpoint:{}".format(args.checkpoint) + info["confmat_str"] + "\n"
            + "val_loss: " + str(info["loss"]) + "\n\n")
    return info


def run_predict(args, family: str) -> dict:
    """`family`'s evaluation of --checkpoint on the test split (mini_val
    for the mini version), appended to --out_file; with --viz_dir, the
    first batch's camera + BEV prediction figures."""
    cfg = _build_cfg(args, family)
    device = _device(args)
    mesh = _mesh(cfg, device)
    if args.viz_dir:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--viz_dir draws its figures with matplotlib, which is not "
                             "installed here") from None
    testloader = _loaders(cfg, with_txt=True, split_family="nu_a2d", test=True,
                          nworkers=args.nworkers, host_shard=multihost.host_shard(),
                          device=device)
    model = _predict_model(args, cfg, device, mesh)
    if args.viz_dir:
        import matplotlib.pyplot as plt

        from .core.grid import gen_dx_bx
        from .train.steps import MODEL_INPUTS
        from .utils.visualize import compose_prediction_figure

        os.makedirs(args.viz_dir, exist_ok=True)
        dx, bx, _ = gen_dx_bx(cfg.grid.xbound, cfg.grid.ybound, cfg.grid.zbound)
        batch = next(iter(testloader))
        with torch.no_grad():
            out = model(*(batch[k] for k in MODEL_INPUTS))
        bev = out[0] if isinstance(out, tuple) else out
        preds = bev.argmax(dim=1).cpu().numpy()
        imgs = batch["imgs"].cpu().numpy()
        count = min(len(preds), args.viz_count) if multihost.is_main() else 0
        for i in range(count):
            fig = compose_prediction_figure(
                imgs[i], preds[i], bx, dx,
                out_path=os.path.join(args.viz_dir, f"pred_{i:03d}.png"))
            plt.close(fig)
        _say(f"wrote {count} figures to {args.viz_dir}")
    info = _evaluate(cfg, model, testloader, no_bev=args.no_bev)
    if "confmat_str" in info:
        _say(info["confmat_str"])
    report = {
        k: (v.tolist() if isinstance(v, np.ndarray) else v)
        for k, v in info.items()
        if k not in ("confmat", "confmat_str")
    }
    _say(report)
    ad_info = """
                    F1_Action: {0}
                    F1_Description: {1}
                    Action_overall: {2}
                    Description_overall: {3}
                    Action_mean: {4}
                    Description_mean: {5}
                    """.format(
        info.get("act_f1"), info.get("desc_f1"), info.get("act_overall"),
        info.get("desc_overall"), info.get("act_mean"), info.get("desc_mean"),
    )
    _say(ad_info)
    _append(args.out_file, args.checkpoint + "\n" + info.get("confmat_str", "") + "\n"
            + "F1_info: " + ad_info + "\n\n")
    return info


def add_common(p: argparse.ArgumentParser, lr: float = 1e-4, wdecay: float = 1e-8,
               bsize: int = 6, max_grad_norm: float = 5.0, nepochs: int = 50,
               eval_every: int = 1, ckpt_every: int = 0, save_best: bool = False,
               rand_flip: bool = False, logdir: str = "./result-log/",
               results_file: str = "result.txt", nworkers: int = 10):
    """The flags every subcommand takes, with the subcommand's defaults."""
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; exits without one) or 'cpu'")
    p.add_argument("--version", default="trainval", choices=["trainval", "mini"])
    p.add_argument("--dataroot", default="/data/nu-A2D")
    p.add_argument("--nepochs", default=nepochs, type=int)
    p.add_argument("--logdir", default=logdir)
    p.add_argument("--bsize", default=bsize, type=int)
    p.add_argument("--nworkers", default=nworkers, type=int)
    p.add_argument("--wandb", action="store_true", help="log to wandb")
    p.add_argument("--wandb_project", default="lss2-multimodal-nu-tpu")
    p.add_argument("--wandb_watch", action="store_true",
                   help="with --wandb: per-module gradient norms and histograms each "
                        "--log_every steps")
    p.add_argument("--worker_type", default="process", choices=["thread", "process"],
                   help="the loader's workers")
    p.add_argument("--lr", default=lr, type=float)
    p.add_argument("--wdecay", default=wdecay, type=float)
    p.add_argument("--max_grad_norm", default=max_grad_norm, type=float)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seg_classes", default=4, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--log_every", default=200, type=int)
    p.add_argument("--results_file", default=results_file)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--nondeterministic_aug", action="store_true",
                   help="augmentation from the OS's entropy, as the original repo")
    p.add_argument("--xbound", nargs=3, type=float, default=[-50.0, 50.0, 0.5])
    p.add_argument("--ybound", nargs=3, type=float, default=[-50.0, 50.0, 0.5])
    p.add_argument("--zbound", nargs=3, type=float, default=[-10.0, 10.0, 20.0])
    p.add_argument("--dbound", nargs=3, type=float, default=[4.0, 45.0, 1.0])
    p.add_argument("--H", default=900, type=int)
    p.add_argument("--W", default=1600, type=int)
    p.add_argument("--final_dim", nargs=2, type=int, default=[128, 352])
    p.add_argument("--resize_lim", nargs=2, type=float, default=[0.193, 0.225])
    p.add_argument("--bot_pct_lim", nargs=2, type=float, default=[0.0, 0.22])
    p.add_argument("--rot_lim", nargs=2, type=float, default=[-5.4, 5.4])
    p.add_argument("--rand_flip", action=argparse.BooleanOptionalAction, default=rand_flip)
    p.add_argument("--ncams", default=6, type=int)
    p.add_argument("--effnet_variant", default="b4")
    p.add_argument("--vovnet_type", default="vovnet39",
                   choices=["vovnet39", "vovnet57", "vovnet99"])
    p.add_argument("--lss_version", default="v1", choices=["v1", "v2"])
    p.add_argument("--version_flags", default="V3", choices=["V1", "V2", "V3"])
    p.add_argument("--use_schedule", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--warmup_epochs", default=5, type=int, help="the schedule's warmup")
    p.add_argument("--eval_every", default=eval_every, type=int,
                   help="validate every N epochs")
    p.add_argument("--ckpt_every", default=ckpt_every, type=int,
                   help="periodic checkpoints every N epochs")
    p.add_argument("--save_best", action=argparse.BooleanOptionalAction, default=save_best,
                   help="keep the best-mIoU checkpoint")
    p.add_argument("--dp", default=1, type=int,
                   help="data-parallel ranks (dp x fsdp = the processes torchrun starts)")
    p.add_argument("--fsdp", default=1, type=int,
                   help="ranks each parameter is sharded over (FSDP2 where > 1)")


# each subcommand's defaults where they differ from add_common's, the
# original repo's per-script values
DEFAULTS = {
    "pretrain": dict(lr=1e-3, wdecay=1e-7, rand_flip=True, nepochs=10000,
                     logdir="./pretrain_result/", results_file="pretrain-result.txt"),
    "pretrain-v2": dict(lr=1e-4, wdecay=1e-8, bsize=12, nepochs=60, rand_flip=True, nworkers=4,
                        logdir="./pretrain_vovnet", eval_every=5, ckpt_every=10,
                        save_best=True),
    "train-v2": dict(lr=1e-4, wdecay=1e-8, bsize=8, max_grad_norm=10.0, nepochs=60,
                     eval_every=5, ckpt_every=10, save_best=True, rand_flip=True, nworkers=4,
                     logdir="./checkpoints_vovnet_transformer"),
    "predict": dict(bsize=1, rand_flip=True, lr=1e-3, wdecay=1e-7, nepochs=10000,
                    logdir="./test-result/"),
    "predict-iou": dict(bsize=1, rand_flip=True, lr=1e-3, wdecay=1e-7, nepochs=10000,
                        logdir="./test-result/"),
}
# subcommand -> (model family, txt labels, split family) of a training run
TRAINING = {
    "pretrain": ("lss", False, "nuscenes_full"),
    "train": ("bev_txt", True, "nu_a2d"),
    "train-onlybev": ("bev_txt_onlybev", True, "nu_a2d"),
    # the full nuScenes splits, without act/desc, as stage 1 of Stack A
    "pretrain-v2": ("vovnet_pretrain", False, "nuscenes_full"),
    "train-v2": ("vovnet_transformer", True, "nu_a2d"),
}
# subcommand -> the model family it builds
FAMILY = {**{cmd: v[0] for cmd, v in TRAINING.items()}, "predict": "bev_txt",
          "predict-iou": "lss"}


def build_parser() -> argparse.ArgumentParser:
    """The parser of every subcommand and its flags."""
    from .train.checkpoint import BEST_PRETRAINED

    parser = argparse.ArgumentParser("lss2_multimodal_nu_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in FAMILY:
        p = sub.add_parser(name)
        add_common(p, **DEFAULTS.get(name, {}))
        if name == "train-v2":
            # the file pretrain-v2 writes under its default --logdir
            p.add_argument("--pretrained_path", default=f"./pretrain_vovnet/{BEST_PRETRAINED}")
            p.add_argument("--no_pretrained", action="store_true",
                           help="disable the default stage-1 warm start")
            p.add_argument("--run_name", default="", help="wandb run name")
            p.add_argument("--save_suffix", default="", help="appended to --logdir")
        if name == "predict":
            p.add_argument("--out_file", default="./test.txt")
            p.add_argument("--no_bev", action="store_true",
                           help="act/desc-only evaluation")
            p.add_argument("--viz_dir", default="",
                           help="save camera + BEV prediction figures here (needs matplotlib)")
            p.add_argument("--viz_count", default=4, type=int)
        if name == "predict-iou":
            p.add_argument("--out_file", default="./b1_20.txt")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    # the group the command joins, it leaves at its end (a caller's stays)
    joined = torch.distributed.is_available() and torch.distributed.is_initialized()
    try:
        if args.cmd in TRAINING:
            family, with_txt, split_family = TRAINING[args.cmd]
            return run_training(args, family, with_txt=with_txt, split_family=split_family)
        if args.cmd == "predict":
            return run_predict(args, FAMILY["predict"])
        return run_predict_iou(args)
    finally:
        if not joined:
            multihost.shutdown()


if __name__ == "__main__":
    main()
