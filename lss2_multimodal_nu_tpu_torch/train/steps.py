"""Train and eval steps (counterpart of the JAX package's `train/steps.py`).

A batch is a dict of tensors on the model's device: the model inputs of
`MODEL_INPUTS` (imgs (B, N, 3, H, W) and the calibration), `binimg`
(B, X, Y) int labels, and for the multitask families `act` (B, 4) and
`desc` (B, 8) float 0/1 targets.

`train_step` runs one optimisation step of a model in training mode: forward
with dropout and drop-connect drawn from a stream seeded by
(cfg.train.seed, step), as the
JAX step folds the step into its key; the loss; backward; the global-norm
clip; Adam; one step of the schedule. Its metrics stay on the device
(0-dim tensors), so a loop pays no host sync unless it reads them. Both
steps run in full float32 precision whatever torch's TF32 flags say
(`ops/_precision.py`): the backward's convolutions go through cuDNN too,
outside the model's forward. A train step also holds cuDNN to deterministic
algorithms (`ops/_precision.py::deterministic_cudnn`): with the port's
kernels, which sum in fixed orders, a step on one card repeats bit for bit
from the same state and batch (loss, gradients, weights, Adam's moments).

In a group of more than one rank (`parallel/`), each rank runs its shard of
the global batch: batch norm and the loss normalisers take the global
batch's sums (`nn/layers.py::conv_bn`, `train/losses.py`), the gradients
are summed over the group (`parallel/mesh.py::reduce_gradients`, or FSDP2's
reduce-scatter), the clip sees the global norm, and the returned loss and
its components are the global batch's, summed over the group on the device.
The dropout rule: at world 1 the stream is seeded by (seed, step), as
above; at world > 1 by (seed, step, rank), so that each rank draws its own
masks for its own samples (the JAX package draws one mask over the global
batch, which no seeding per rank could match bit for bit).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops._precision import deterministic_cudnn, full_float32
from ..nn.layers import DropConnect
from ..parallel import multihost
from ..parallel.mesh import reduce_gradients
from .losses import cross_entropy_ignore, multi_loss, multi_task_loss, simple_loss
from .metrics import confusion_matrix_update

Batch = Dict[str, torch.Tensor]

MODEL_INPUTS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")
# the families whose model returns the BEV logits alone
BEV_ONLY = ("lss", "vovnet_pretrain")


def compute_loss(cfg: Config, out, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", and the family's components}) of the model's output."""
    family = cfg.model.family
    if family == "lss":
        loss = simple_loss(out, batch["binimg"])
        return loss, {"loss": loss}
    if family == "vovnet_pretrain":
        loss = cross_entropy_ignore(out, batch["binimg"])
        return loss, {"loss": loss}
    if family in ("bev_txt", "bev_txt_onlybev"):
        bev, act, desc = out
        loss = multi_loss(bev, act, desc, batch["binimg"], batch["act"], batch["desc"])
        return loss, {"loss": loss}
    if family == "vovnet_transformer":
        bev, act, desc = out
        loss, comps = multi_task_loss(bev, act, desc, batch["binimg"], batch["act"],
                                      batch["desc"])
        return loss, {"loss": loss, **comps}
    raise ValueError(f"unknown model family {family!r}")


def _step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step: a hash of (seed, step) at world 1, of
    (seed, step, rank) in a group of more ranks."""
    key = [seed, step] if multihost.world() == 1 else [seed, step, multihost.host_shard()[0]]
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def train_without_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """`model.train()` with every Dropout, attention dropout and
    drop-connect off: batch norm on batch statistics and the op-by-op
    training paths, but no random masks, so that a train step can be
    compared with another one."""
    model.train()
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention, DropConnect)):
            m.eval()
    return model


@full_float32()
@deterministic_cudnn()
def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               scheduler: torch.optim.lr_scheduler.LRScheduler, batch: Batch,
               step: int, mark: Optional[Callable[[str], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One step; returns {loss, the family's loss components, grad_norm}
    (the flagship's components are bev, action and desc), where grad_norm
    is the global norm before clipping, and with `cfg.train.watch_gradients`
    the `grad_watch_summaries` of the gradients. `mark`, if given, is
    called with "forward", "backward" and "optimizer" as each part ends (a
    timer records a CUDA event there)."""
    if not model.training:
        raise ValueError("train_step needs the model in training mode (model.train())")
    mark = mark or (lambda part: None)
    cfg = model.cfg
    device = batch["imgs"].device
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(_step_seed(cfg.train.seed, step))
        out = model(*(batch[k] for k in MODEL_INPUTS))
        loss, metrics = compute_loss(cfg, out, batch)
        mark("forward")
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(model)
        mark("backward")
    watch = grad_watch_summaries(_grads_by_module(model)) if cfg.train.watch_gradients else {}
    grad_norm = torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.train.max_grad_norm)
    if hasattr(grad_norm, "full_tensor"):  # FSDP2: the DTensor of the global norm
        grad_norm = grad_norm.full_tensor()
    optimizer.step()
    scheduler.step()
    mark("optimizer")
    return {**_global_metrics(metrics), "grad_norm": grad_norm, **watch}


def _global_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The metrics detached; in a group, each summed over the ranks (each
    rank's loss is its share of the global batch's), in one all-reduce
    on the device."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not multihost.joined():
        return metrics
    summed = multihost.all_reduce_sum(torch.stack([v.float() for v in metrics.values()]))
    return dict(zip(metrics, summed.unbind()))


def _grads_by_module(model: torch.nn.Module) -> Dict[str, list]:
    """{top-level module: its parameters' gradients, in registration
    order}; parameters without a gradient are left out."""
    out: Dict[str, list] = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad
            out.setdefault(name.split(".")[0], []).append(g)
    return out


@torch.no_grad()
def grad_watch_summaries(grads: Dict[str, Sequence[torch.Tensor]],
                         sample_per_module: int = 2048) -> Dict[str, torch.Tensor]:
    """wandb.watch's view of the gradients, on their device: for each
    top-level module, `grad_norm/<module>`, the global norm of its
    gradients, and `grad_sample/<module>`, a strided sample of at most
    `sample_per_module` float32 values for a histogram, the same number
    from each leaf (every stride-th value), as the JAX package's
    `train/steps.py::grad_watch_summaries` takes it. Nothing is concatenated
    but the samples."""
    out: Dict[str, torch.Tensor] = {}
    for mod, leaves in grads.items():
        out[f"grad_norm/{mod}"] = torch.sqrt(sum(x.float().square().sum() for x in leaves))
        per_leaf = max(sample_per_module // len(leaves), 1)
        samples = []
        for x in leaves:
            flat = x.reshape(-1)
            stride = max(flat.numel() // per_leaf, 1)
            samples.append(flat[::stride][:per_leaf].float())
        out[f"grad_sample/{mod}"] = torch.cat(samples)[:sample_per_module]
    return out


@full_float32()
@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Batch, confmat: torch.Tensor) -> Dict:
    """Eval forward of a model in eval mode; returns {confmat (updated),
    loss, bsize}, and for the multitask families act_pred and desc_pred, the
    predictions as sigmoid > 0.5 (LSS and the pretrain model predict the BEV
    alone)."""
    if model.training:
        raise ValueError("eval_step needs the model in eval mode (model.eval())")
    cfg = model.cfg
    out = model(*(batch[k] for k in MODEL_INPUTS))
    loss, _ = compute_loss(cfg, out, batch)
    multitask = cfg.model.family not in BEV_ONLY
    bev = out[0] if multitask else out
    confmat = confusion_matrix_update(confmat, batch["binimg"], bev.argmax(dim=1),
                                      cfg.model.seg_classes)
    res = {"confmat": confmat, "loss": loss, "bsize": bev.shape[0]}
    if multitask:
        res["act_pred"] = torch.sigmoid(out[1].float()) > 0.5
        res["desc_pred"] = torch.sigmoid(out[2].float()) > 0.5
    return res
