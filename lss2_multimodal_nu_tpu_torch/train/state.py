"""Optimizer and learning-rate schedule (counterpart of the JAX package's
`train/state.py`).

`torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)` adds the
decay to the gradient before the moments (coupled L2), as the JAX package's
`optax.add_decayed_weights` before `scale_by_adam` does. The flagship trains
in two parameter groups: `backbone`, `depth_net`, `cam_encode` and
`bev_encoder` at lr * backbone_lr_mult, the rest at lr. Every other family
trains in one group at lr. The warmup-cosine schedule is a
`LambdaLR` stepped once per batch, so step k's rate is lr *
`warmup_cosine_multiplier(...)(k)`, the JAX package's
`warmup_cosine_schedule(lr, ...)(k)`: 0 at step 0 under warmup, as optax's
count starts at 0. The global-norm clip at `max_grad_norm` happens in the
train step, before `optimizer.step()`.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..config import Config

# modules trained at lr * backbone_lr_mult
PRETRAINED_PREFIXES = ("backbone", "depth_net", "cam_encode", "bev_encoder")


def warmup_cosine_multiplier(warmup_steps: int, total_steps: int,
                             min_lr_mult: float = 1e-6) -> Callable[[int], float]:
    """The schedule as a multiplier of the base rate: linear warmup, then a
    cosine whose floor is `min_lr_mult` (a multiplier floor, so the rate's
    floor is base_lr * min_lr_mult, as in the original repo)."""

    def fn(step: int) -> float:
        if step < warmup_steps:
            return step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return max(min_lr_mult, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return fn


def build_optimizer(cfg: Config, model: torch.nn.Module, steps_per_epoch: Optional[int] = None
                    ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """(Adam, its per-batch LambdaLR) over the model's parameters, in the
    family's parameter groups; with
    `cfg.train.use_schedule` the schedule needs `steps_per_epoch`, without it
    the rates stay constant."""
    tc = cfg.train
    if tc.use_schedule:
        if steps_per_epoch is None:
            raise ValueError("the warmup-cosine schedule needs steps_per_epoch")
        mult = warmup_cosine_multiplier(tc.warmup_epochs * steps_per_epoch,
                                        tc.num_epochs * steps_per_epoch, tc.min_lr)
    else:
        mult = lambda step: 1.0
    if cfg.model.family == "vovnet_transformer":
        low, high = [], []
        for name, p in model.named_parameters():
            (low if name.split(".")[0] in PRETRAINED_PREFIXES else high).append(p)
        groups = [{"params": low, "lr": tc.lr * tc.backbone_lr_mult},
                  {"params": high, "lr": tc.lr}]
    else:
        groups = [{"params": list(model.parameters()), "lr": tc.lr}]
    opt = torch.optim.Adam(groups, lr=tc.lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=tc.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, mult)
