"""Eval metrics on tensors (reference model/evaluation.py:8-31).

Prediction rule (evaluation.py:14-23):
- sigmoid path: ``round(sigmoid(logits))`` as ints (round half to even);
- softmax path: one-hot of the argmax.
Accuracy is sklearn's multilabel ``accuracy_score`` (exact row match); F1
is per-class binary F1 with ``zero_division=0``, weighted or macro.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def predictions(logits: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "sigmoid":
        return torch.round(torch.sigmoid(logits)).to(torch.int32)
    a = logits.argmax(dim=1)
    return torch.nn.functional.one_hot(a, logits.shape[1]).to(torch.int32)


def subset_accuracy(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (pred == y.to(pred.dtype)).all(dim=1).float().mean()


def _per_class(pred: torch.Tensor, y: torch.Tensor):
    """(precision, recall, f1, support) per class, zero_division=0."""
    y = y.to(torch.int32)
    tp = ((pred == 1) & (y == 1)).sum(0).float()
    fp = ((pred == 1) & (y == 0)).sum(0).float()
    fn = ((pred == 0) & (y == 1)).sum(0).float()
    precision = torch.where(tp + fp > 0, tp / (tp + fp).clamp(min=1), 0.0)
    recall = torch.where(tp + fn > 0, tp / (tp + fn).clamp(min=1), 0.0)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall / (precision + recall).clamp(min=1e-30),
                     0.0)
    return precision, recall, f1, (y == 1).sum(0).float()


def f1_score(pred: torch.Tensor, y: torch.Tensor,
             average: str = "weighted") -> torch.Tensor:
    _, _, f1, support = _per_class(pred, y)
    if average == "macro":
        return f1.mean()
    return (f1 * support).sum() / support.sum().clamp(min=1.0)


def evaluate(logits: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             activation: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(subset accuracy, weighted F1, macro F1) on eval node subset ``x``."""
    pred = predictions(logits, activation)[x]
    return (subset_accuracy(pred, y), f1_score(pred, y, "weighted"),
            f1_score(pred, y, "macro"))


def classification_table(pred: torch.Tensor, y: torch.Tensor) -> str:
    """Per-class precision / recall / F1 / support with macro and weighted
    averages (the numbers of sklearn's ``classification_report``)."""
    p, r, f, s = (t.cpu().numpy() for t in _per_class(pred, y))
    rows = [f"{'':>14}{'precision':>10}{'recall':>10}{'f1-score':>10}{'support':>10}"]
    for c in range(len(p)):
        rows.append(f"{c:>14}{p[c]:>10.2f}{r[c]:>10.2f}{f[c]:>10.2f}{int(s[c]):>10}")
    total = max(s.sum(), 1.0)
    for name, wts in (("macro avg", np.full(len(p), 1.0 / max(len(p), 1))),
                      ("weighted avg", s / total)):
        rows.append(f"{name:>14}{(p * wts).sum():>10.2f}{(r * wts).sum():>10.2f}"
                    f"{(f * wts).sum():>10.2f}{int(s.sum()):>10}")
    return "\n".join(rows)
