"""Loss functions with the original model's class weights and torch's
normalisation (counterpart of the JAX package's `train/losses.py`).

The port's BEV logits are NCHW (B, C, X, Y), so the class axis is 1; labels
are (B, X, Y) integers. Action and description logits are (B, 4) and (B, 8)
with float 0/1 targets. Every loss runs in float32 whatever the logits'
dtype. The flagship trains on `multi_task_loss`, Stack A's LSS on
`simple_loss` and BevTxt and BevTxtOnlyBev on `multi_loss`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

BEV_CLASS_WEIGHTS = (1.0, 10.0, 5.0, 10.0)
ACT_WEIGHTS = (1.0, 5.0, 5.0, 5.0)
DESC_WEIGHTS = (1.0, 5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 1.0)
ACT_WEIGHTS_NOBEV = (20.0, 250.0, 250.0, 250.0)
DESC_WEIGHTS_NOBEV = (20.0, 400.0, 400.0, 400.0, 20.0, 20.0, 20.0, 20.0)
ACT_POS_WEIGHT_V2 = (5.0, 5.0, 5.0, 5.0)
DESC_POS_WEIGHT_V2 = (5.0, 5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 1.0)


@lru_cache(maxsize=None)
def _const_on(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    # made outside inference mode: a later train step saves it for backward
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """The float32 weights `values` on like's device, made once per (values,
    device): a copy from the host each call would make the host wait for the
    card."""
    return _const_on(tuple(values), like.device)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Sequence[float]) -> torch.Tensor:
    """`nn.CrossEntropyLoss(weight=w)`: the weighted mean, normalised by the
    sum of the samples' weights (not their count)."""
    return F.cross_entropy(logits.float(), labels.long(), weight=_const(class_weights, logits))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, weight=None,
                    pos_weight=None) -> torch.Tensor:
    """`F.binary_cross_entropy_with_logits`, plain mean: `weight` scales each
    element's loss, `pos_weight` only the positive term."""
    logits = logits.float()
    return F.binary_cross_entropy_with_logits(
        logits, targets.float(),
        weight=None if weight is None else _const(weight, logits),
        pos_weight=None if pos_weight is None else _const(pos_weight, logits))


def simple_loss(bev_logits: torch.Tensor, bev_labels: torch.Tensor) -> torch.Tensor:
    """LSS's loss: weighted cross entropy over the 4 BEV classes."""
    return weighted_cross_entropy(bev_logits, bev_labels, BEV_CLASS_WEIGHTS)


def multi_loss(bev_logits, act_logits, desc_logits, bev_labels, act_labels,
               desc_labels) -> torch.Tensor:
    """BevTxt's loss: weighted CE on the BEV plus BCEs on action and
    description whose per-element `weight` scales each term (not
    `pos_weight`), summed with unit weights."""
    return (weighted_cross_entropy(bev_logits, bev_labels, BEV_CLASS_WEIGHTS)
            + bce_with_logits(act_logits, act_labels, weight=ACT_WEIGHTS)
            + bce_with_logits(desc_logits, desc_labels, weight=DESC_WEIGHTS))


def multi_loss_nobev(act_logits, desc_logits, act_labels, desc_labels) -> torch.Tensor:
    """Action and description BCEs alone, with the heavier weights."""
    return (bce_with_logits(act_logits, act_labels, weight=ACT_WEIGHTS_NOBEV)
            + bce_with_logits(desc_logits, desc_labels, weight=DESC_WEIGHTS_NOBEV))


def multi_task_loss(bev_logits, act_logits, desc_logits, bev_labels, act_labels, desc_labels,
                    bev_weight: float = 1.0, action_weight: float = 0.5,
                    desc_weight: float = 0.5) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The flagship's task-balanced loss: weighted CE on the BEV plus
    pos-weighted BCEs on action and description. Returns (total,
    {"bev", "action", "desc"})."""
    loss_bev = weighted_cross_entropy(bev_logits, bev_labels, BEV_CLASS_WEIGHTS)
    loss_act = bce_with_logits(act_logits, act_labels, pos_weight=ACT_POS_WEIGHT_V2)
    loss_desc = bce_with_logits(desc_logits, desc_labels, pos_weight=DESC_POS_WEIGHT_V2)
    total = bev_weight * loss_bev + action_weight * loss_act + desc_weight * loss_desc
    return total, {"bev": loss_bev, "action": loss_act, "desc": loss_desc}


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255) -> torch.Tensor:
    """`nn.CrossEntropyLoss(ignore_index=...)`: the unweighted mean over the
    pixels not ignored; 0 (not NaN) when every pixel is ignored, as in the
    JAX package."""
    labels = labels.long()
    total = F.cross_entropy(logits.float(), labels, ignore_index=ignore_index, reduction="sum")
    return total / (labels != ignore_index).sum().clamp(min=1)
