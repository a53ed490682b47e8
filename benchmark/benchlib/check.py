"""The comparison that decides `correct`: what the timed path produced
against the plain reference (`benchmark/reference/`), run once the window
has closed, on the same weights and batches, made again from the seed.

Training (kind "train"): twice three steps through the window's own call,
each on three different batches. The first three are set-up's, from the
weights made from the seed; the reference follows them from the same
weights. The late three run on the window's object once the window has
closed; the reference follows them from the program's state as it was
copied to the host before them (weights, buffers, Adam's moments and step
counts, the step index): the one place where it takes the program's own
state, since only that state shows what the window's steps did. Numbers
of each three (the late ones prefixed `late_`): `loss_gap`, the largest
relative gap of a step's loss, and `loss0_gap`, the first step's alone;
`grad_gap`, over every leaf, the gap between the norms of the first
step's gradient as Adam took it (from the program's Adam state:
(exp_avg after - beta1 exp_avg before) / (1 - beta1)) over the larger of
the reference leaf's norm and the median leaf's; `change_gap`, the same for
each parameter's change over the three steps, over the leaves whose
reference gradient is at least a thousandth of the median leaf's (smaller
ones move under Adam by round-off alone), and `change_gap_median`, the
median leaf's gap. Which of them a cell compares is its limits file's
choice.

Eval (kind "eval"): the last request of every batch of the pool that the
window served. Numbers: `bev_gap` and `head_gap`, the largest gap of the
BEV logits and of the action and description logits over the largest
reference logit of that output; `loss_gap`; `confmat_excess`, the counts by
which the confusion matrix differs from the reference argmax's beyond what
its unclear pixels can move (two counts each: a pixel whose two largest
logits lie within `FLIP_MARGIN` of the largest logit); `pred_flips`, the
action and description predictions that disagree with the reference's sign
where the reference's logit is clear of 0 by `FLIP_MARGIN` of its largest.
The last two compare answers exactly.

`precision` runs the reference in full float32 ("float32") or with TF32 on
("tf32"), the precision below: the control (`as_program` puts its outputs
in the program's form).
"""
from __future__ import annotations

import statistics
from contextlib import contextmanager
from typing import Dict, List

import torch

from reference import train as ref_train

from . import weights as weights_mod

FLIP_MARGIN = 1e-3
GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median's


@contextmanager
def precision(kind: str):
    """The reference's float32 products in full float32, or in TF32."""
    tf32 = kind == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def reference_model(cfg: dict, seed: int, device, overrides):
    """The reference with the weights made from the seed, `overrides` (the
    calibrated batch-norm statistics) put in."""
    model = ref_train.build(cfg, device)
    weights = weights_mod.make(model, seed, device)
    weights.update({k: v.to(device) for k, v in overrides.items()})
    model.load_state_dict(weights)
    return model


def reference_train(cfg, seed, kept, steps_per_epoch, device, overrides, kind):
    """{"early": ..., "late": ...}, each (losses, first gradients, changes)
    of the reference's three steps, on the host."""
    host = lambda d: {k: v.float().cpu() for k, v in d.items()}  # noqa: E731
    out = {}
    model = reference_model(cfg, seed, device, overrides)
    for part in ("early", "late"):
        moments, first_step = None, 0
        if part == "late":
            model.load_state_dict({k: v.to(device) for k, v in kept["late_state"].items()})
            moments = {n: tuple(x.to(device) if torch.is_tensor(x) else x for x in m)
                       for n, m in kept["late_moments"].items()}
            first_step = kept["late_step"]
        with precision(kind):
            losses, first, change = ref_train.train_steps(
                model, cfg, kept[part], seed, steps_per_epoch, first_step, moments)
        out[part] = ([float(x) for x in losses], host(first), host(change))
    return out


def reference_eval(cfg, seed, batches: Dict[int, dict], device, overrides, kind):
    """{slot: (bev, act, desc, loss)} of the reference's eval forwards, on
    the host."""
    model = reference_model(cfg, seed, device, overrides)
    out = {}
    with precision(kind):
        for slot, batch in batches.items():
            bev, act, desc, loss = ref_train.eval_forward(model, cfg, batch)
            out[slot] = (bev.cpu(), act.cpu(), desc.cpu(), float(loss))
    return out


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double())) if t is not None else 0.0


def _leaf_gaps(got, want, names) -> List[float]:
    ref = {n: _norm(want.get(n)) for n in names}
    med = statistics.median(ref.values())
    return [abs(_norm(got.get(n)) - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def train_numbers(prog, ref, prefix: str = "") -> Dict[str, float]:
    """prog and ref: (losses, first gradients, changes)."""
    (lp, gp, cp), (lr, gr, cr) = prog, ref
    grads = sorted(set(gp) | set(gr))
    med = statistics.median(_norm(gr.get(n)) for n in grads)
    moved = [n for n in sorted(gr) if _norm(gr[n]) >= GRAD_FLOOR * med]
    loss = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
    change = _leaf_gaps(cp, cr, moved)
    return {prefix + k: v for k, v in {
        "loss_gap": max(loss),
        "loss0_gap": loss[0],
        "grad_gap": max(_leaf_gaps(gp, gr, grads)),
        "change_gap": max(change),
        "change_gap_median": statistics.median(change),
    }.items()}


def confusion(labels, preds, n: int) -> torch.Tensor:
    k = (labels >= 0) & (labels < n)
    return torch.bincount((n * labels[k] + preds[k]).reshape(-1), minlength=n * n).reshape(n, n)


def eval_numbers(prog: Dict[int, dict], ref: Dict[int, tuple], labels: Dict[int, torch.Tensor],
                 classes: int) -> Dict[str, float]:
    """prog: {slot: {bev, act, desc, loss, act_pred, desc_pred, confmat}} on
    the host; ref: {slot: (bev, act, desc, loss)}; labels: {slot: binimg}."""
    out = {"bev_gap": 0.0, "head_gap": 0.0, "loss_gap": 0.0, "confmat_excess": 0,
           "pred_flips": 0}
    rel = lambda a, b: float((a.double() - b.double()).abs().max() / b.double().abs().max())  # noqa
    for slot, p in prog.items():
        bev, act, desc, loss = ref[slot]
        out["bev_gap"] = max(out["bev_gap"], rel(p["bev"], bev))
        out["head_gap"] = max(out["head_gap"], rel(p["act"], act), rel(p["desc"], desc))
        out["loss_gap"] = max(out["loss_gap"], abs(p["loss"] - loss) / abs(loss))
        cm = confusion(labels[slot].long(), bev.argmax(dim=1), classes)
        top2 = bev.topk(2, dim=1).values
        unclear = int((top2[:, 0] - top2[:, 1] <= FLIP_MARGIN * bev.abs().max()).sum())
        moved = int((p["confmat"].long() - cm).abs().sum())
        out["confmat_excess"] += max(0, moved - 2 * unclear)
        for pred, logit in ((p["act_pred"], act), (p["desc_pred"], desc)):
            clear = logit.abs() > FLIP_MARGIN * logit.abs().max()
            out["pred_flips"] += int((pred.bool() != (logit > 0))[clear].sum())
    return out


def eval_as_program(ref_out: Dict[int, tuple], labels: Dict[int, torch.Tensor],
                    classes: int) -> Dict[int, dict]:
    """Reference eval outputs in the form of the port's answers (the
    control put in the port's place): predictions as sigmoid > 0.5, the
    confusion matrix of the BEV argmax."""
    return {s: {"bev": bev, "act": act, "desc": desc, "loss": loss, "act_pred": act > 0,
                "desc_pred": desc > 0,
                "confmat": confusion(labels[s].long(), bev.argmax(dim=1), classes)}
            for s, (bev, act, desc, loss) in ref_out.items()}


def _labels(kept) -> Dict[int, torch.Tensor]:
    return {s: b["binimg"].cpu() for s, b in kept.items()}


def reference(kind: str, cfg, seed, kept, steps_per_epoch, device, overrides, prec="float32"):
    """The reference's outputs of a loop of `kind` on the kept batches."""
    if kind == "train":
        return reference_train(cfg, seed, kept, steps_per_epoch, device, overrides, prec)
    return reference_eval(cfg, seed, kept, device, overrides, prec)


def as_program(kind: str, cfg, ref_out, kept):
    """The reference's outputs in the form of the program's (`got`)."""
    if kind == "train":
        return ref_out
    return eval_as_program(ref_out, _labels(kept), cfg["model"]["seg_classes"])


def numbers(kind: str, cfg, seed, got, kept, steps_per_epoch, device, overrides):
    """The check's numbers of `got` (a loop's `outputs`) against the
    reference in full float32, its weights from the seed with `overrides`."""
    ref = reference(kind, cfg, seed, kept, steps_per_epoch, device, overrides)
    if kind == "train":
        return {**train_numbers(got["early"], ref["early"]),
                **train_numbers(got["late"], ref["late"], "late_")}
    return eval_numbers(got, ref, _labels(kept), cfg["model"]["seg_classes"])


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """The names of the numbers over their limits (a number that is not a
    finite float fails)."""
    bad = []
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None or not (v == v) or v > limit:
            bad.append(name)
    return bad
