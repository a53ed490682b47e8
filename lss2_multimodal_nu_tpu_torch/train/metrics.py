"""Evaluation metrics: the confusion matrix (torch, on the logits' device)
and F1 scores (numpy), counterparts of the JAX package's `train/metrics.py`."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def confusion_matrix_update(mat: torch.Tensor, labels: torch.Tensor, preds: torch.Tensor,
                            num_classes: int) -> torch.Tensor:
    """`mat` plus the (n, n) int counts of (label, prediction) pairs; labels
    outside [0, n) are not counted. No host sync: they are counted in an
    extra bin, where a mask's selection (or `bincount`) would make the
    host wait for the card to learn a size."""
    labels = labels.reshape(-1).long()
    preds = preds.reshape(-1).long()
    k = (labels >= 0) & (labels < num_classes)
    idx = torch.where(k, num_classes * labels + preds, num_classes * num_classes)
    counts = torch.zeros(num_classes ** 2 + 1, dtype=mat.dtype, device=mat.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=mat.dtype))
    return mat + counts[:-1].reshape(num_classes, num_classes)


def confusion_matrix_compute(mat: np.ndarray) -> Dict[str, np.ndarray]:
    """(global acc, per-class acc, per-class IoU, mean IoU)."""
    h = np.asarray(mat).astype(np.float64)
    diag = np.diag(h)
    acc_global = diag.sum() / h.sum()
    acc = diag / h.sum(1)
    iu = diag / (h.sum(1) + h.sum(0) - diag)
    return {"acc_global": acc_global, "acc": acc, "iou": iu, "mean_iou": np.nanmean(iu)}


def format_confusion(mat: np.ndarray) -> str:
    """The original repo's ConfusionMatrix.__str__ format."""
    m = confusion_matrix_compute(mat)
    return (
        "global correct: {:.1f}\n"
        "average row correct: {}\n"
        "IoU: {}\n"
        "mean IoU: {:.1f}".format(
            m["acc_global"] * 100,
            ["{:.1f}".format(i) for i in (m["acc"] * 100).tolist()],
            ["{:.1f}".format(i) for i in (m["iou"] * 100).tolist()],
            m["mean_iou"] * 100,
        )
    )


def binary_f1(targets: np.ndarray, preds: np.ndarray) -> float:
    """sklearn f1_score(binary) for 0/1 arrays: 2TP / (2TP + FP + FN)."""
    targets = np.asarray(targets).astype(bool)
    preds = np.asarray(preds).astype(bool)
    tp = np.sum(targets & preds)
    fp = np.sum(~targets & preds)
    fn = np.sum(targets & ~preds)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def macro_f1(targets: np.ndarray, preds: np.ndarray) -> float:
    """sklearn f1_score(average='macro') over the two classes {0, 1} of a
    flattened binary problem."""
    f1_pos = binary_f1(targets, preds)
    f1_neg = binary_f1(1 - np.asarray(targets), 1 - np.asarray(preds))
    return (f1_pos + f1_neg) / 2.0


def per_class_and_macro_f1(targets: np.ndarray,
                           preds: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Per-class binary F1 over column i, the macro-F1 over the flattened
    matrix, and the per-class mean. targets/preds: (N, C) 0/1 arrays."""
    targets = np.asarray(targets)
    preds = np.asarray(preds)
    c = targets.shape[1]
    per = np.array([binary_f1(targets[:, i], preds[:, i]) for i in range(c)])
    overall = macro_f1(targets.reshape(-1), preds.reshape(-1))
    return per, overall, float(per.mean())
