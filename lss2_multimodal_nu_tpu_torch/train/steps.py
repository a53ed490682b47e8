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
outside the model's forward.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops._precision import full_float32
from ..nn.layers import DropConnect
from .losses import multi_loss, multi_task_loss, simple_loss
from .metrics import confusion_matrix_update

Batch = Dict[str, torch.Tensor]

MODEL_INPUTS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")


def compute_loss(cfg: Config, out, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", and the family's components}) of the model's output."""
    family = cfg.model.family
    if family == "lss":
        loss = simple_loss(out, batch["binimg"])
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
    raise NotImplementedError(f"the loss of family {family!r} is not ported yet: ROADMAP.md "
                              "queue 1 item 13 (pretrain family)")


def _step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step, a hash of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


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
def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               scheduler: torch.optim.lr_scheduler.LRScheduler, batch: Batch,
               step: int, mark: Optional[Callable[[str], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One step; returns {loss, the family's loss components, grad_norm}
    (the flagship's components are bev, action and desc), where grad_norm
    is the global norm before clipping. `mark`, if given, is
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
        mark("backward")
    grad_norm = torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.train.max_grad_norm)
    optimizer.step()
    scheduler.step()
    mark("optimizer")
    return {**{k: v.detach() for k, v in metrics.items()}, "grad_norm": grad_norm}


@full_float32()
@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Batch, confmat: torch.Tensor) -> Dict:
    """Eval forward of a model in eval mode; returns {confmat (updated),
    loss, bsize}, and for the multitask families act_pred and desc_pred, the
    predictions as sigmoid > 0.5 (LSS predicts the BEV alone)."""
    if model.training:
        raise ValueError("eval_step needs the model in eval mode (model.eval())")
    cfg = model.cfg
    out = model(*(batch[k] for k in MODEL_INPUTS))
    loss, _ = compute_loss(cfg, out, batch)
    bev = out if cfg.model.family == "lss" else out[0]
    confmat = confusion_matrix_update(confmat, batch["binimg"], bev.argmax(dim=1),
                                      cfg.model.seg_classes)
    res = {"confmat": confmat, "loss": loss, "bsize": bev.shape[0]}
    if cfg.model.family != "lss":
        res["act_pred"] = torch.sigmoid(out[1].float()) > 0.5
        res["desc_pred"] = torch.sigmoid(out[2].float()) > 0.5
    return res
