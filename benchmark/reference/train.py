"""Plain reference of a training step and an eval forward: the losses with
the original repo's class weights, the global-norm clip, Adam with coupled
L2 decay, the warmup-cosine schedule stepped per batch, and the dropout
stream seeded by (seed, step). Frozen copies of the port's
`train/losses.py`, `train/state.py` and `train/steps.py` at one process,
written with PyTorch calls alone; the cross entropies sum per-pixel terms,
the BCEs are plain means.

`build(cfg, device)` makes the config's reference model on the meta device
or a card without initialising it: the benchmark loads its weights.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BEV_CLASS_WEIGHTS = (1.0, 10.0, 5.0, 10.0)
ACT_WEIGHTS = (1.0, 5.0, 5.0, 5.0)
DESC_WEIGHTS = (1.0, 5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 1.0)
ACT_POS_WEIGHT_V2 = (5.0, 5.0, 5.0, 5.0)
DESC_POS_WEIGHT_V2 = (5.0, 5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 1.0)
MODEL_INPUTS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def build(cfg: dict, device) -> torch.nn.Module:
    """The reference model of cfg["reference"], its tensors uninitialised
    on `device`."""
    ref = cfg["reference"]
    cls = getattr(importlib.import_module(f"{__package__}.{ref['module']}"), ref["model"])
    with torch.device("meta"):
        model = cls(cfg)
    return model if torch.device(device).type == "meta" else model.to_empty(device=device)


def _w(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def weighted_ce(logits, labels, weights):
    w = _w(weights, logits)[labels.long()]
    return (w * F.cross_entropy(logits, labels.long(), reduction="none")).sum() / w.sum()


def bce(logits, targets, weight=None, pos_weight=None):
    return F.binary_cross_entropy_with_logits(
        logits, targets, weight=None if weight is None else _w(weight, logits),
        pos_weight=None if pos_weight is None else _w(pos_weight, logits))


def loss_of(cfg: dict, out, batch) -> torch.Tensor:
    bev, act, desc = out
    kind = cfg["reference"]["loss"]
    ce = weighted_ce(bev, batch["binimg"], BEV_CLASS_WEIGHTS)
    if kind == "multi_task_loss":  # the flagship's task-balanced loss
        return (ce + 0.5 * bce(act, batch["act"], pos_weight=ACT_POS_WEIGHT_V2)
                + 0.5 * bce(desc, batch["desc"], pos_weight=DESC_POS_WEIGHT_V2))
    if kind == "multi_loss":  # BevTxt's: element weights, unit task weights
        return ce + bce(act, batch["act"], weight=ACT_WEIGHTS) + bce(desc, batch["desc"],
                                                                     weight=DESC_WEIGHTS)
    raise ValueError(f"no reference loss {kind!r}")


def step_seed(seed: int, step: int) -> int:
    """The dropout stream's seed of one step at world 1."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def lr_multiplier(tc: dict, steps_per_epoch: int, step: int) -> float:
    if not tc.get("use_schedule", False):
        return 1.0
    warm = tc["warmup_epochs"] * steps_per_epoch
    total = tc["num_epochs"] * steps_per_epoch
    if step < warm:
        return step / max(warm, 1)
    progress = (step - warm) / max(total - warm, 1)
    return max(tc["min_lr"], 0.5 * (1.0 + math.cos(math.pi * progress)))


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) with the decay added to the gradient
    first; a parameter whose name starts with one of `low_prefixes` trains
    at lr * backbone_lr_mult."""

    def __init__(self, named_params, tc: dict, low_prefixes):
        self.params = [(n, p) for n, p in named_params]
        self.tc = tc
        self.scale = {n: tc["backbone_lr_mult"] if n.split(".")[0] in low_prefixes else 1.0
                      for n, _ in self.params}
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t: Dict[str, int] = {}

    @torch.no_grad()
    def step(self, lr: float) -> Dict[str, torch.Tensor]:
        """One update; returns each stepped leaf's gradient as Adam took it
        (with the decay), a copy."""
        wd, (b1, b2) = self.tc["weight_decay"], BETAS
        taken = {}
        for n, p in self.params:
            if p.grad is None:
                continue
            g = p.grad + wd * p
            taken[n] = g.clone()
            t = self.t[n] = self.t.get(n, 0) + 1
            m = self.m[n] = self.m.get(n, torch.zeros_like(p)).mul_(b1).add_(g, alpha=1 - b1)
            v = self.v[n] = self.v.get(n, torch.zeros_like(p)).mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-lr * self.scale[n] / (1 - b1 ** t))
        return taken


def clip_grad_norm(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    grads = [p.grad for p in params if p.grad is not None]
    total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total


def train_steps(model, cfg: dict, batches, seed: int, steps_per_epoch: int, first_step: int = 0,
                moments=None):
    """Steps first_step, first_step + 1, ... on `batches` from the model's
    weights and, where given, Adam's `moments` ({name: (exp_avg,
    exp_avg_sq, step count)}; else Adam starts afresh): returns (losses, the
    first step's gradients as Adam took them, each parameter's change after
    the last step), all on the model's device."""
    tc = cfg["train"]
    model.train()
    named = list(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    opt = Adam(named, tc, cfg["reference"].get("low_lr_prefixes", ()))
    for n, (m, v, t) in (moments or {}).items():
        opt.m[n], opt.v[n], opt.t[n] = m.clone(), v.clone(), int(t)
    losses, first = [], None
    device = batches[0]["imgs"].device
    for k, batch in enumerate(batches, start=first_step):
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(step_seed(seed, k))
            loss = loss_of(cfg, model(*(batch[i] for i in MODEL_INPUTS)), batch)
            for _, p in named:
                p.grad = None
            loss.backward()
        clip_grad_norm([p for _, p in named], tc["max_grad_norm"])
        taken = opt.step(tc["lr"] * lr_multiplier(tc, steps_per_epoch, k))
        losses.append(loss.detach())
        first = taken if first is None else first
    change = {n: (p.detach() - start[n]) for n, p in named}
    return losses, first, change


@torch.no_grad()
def eval_forward(model, cfg: dict, batch):
    """(bev, act, desc, loss) of the model in eval mode."""
    model.eval()
    out = model(*(batch[i] for i in MODEL_INPUTS))
    return (*out, loss_of(cfg, out, batch))
