"""Loss + activation selection (reference model/evaluation.py:33-51).

Models emit logits and losses consume logits, the numerically stable form
of the reference's activation + ``BCELoss`` / ``CrossEntropyLoss``:

- summaries, and AIFB full-graph: BCE with sigmoid (soft / multi-label
  targets), mean over all elements;
- other datasets' full-graph: CE on ``targets.argmax(-1)``.

``activation`` ('sigmoid' | 'softmax') selects the prediction rule in
metrics.py (evaluation.py:14-23).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, targets.float())


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, targets.argmax(dim=-1))


def get_loss(dataset: str, sum_model: bool = False) -> Tuple[Callable, str]:
    """(loss_fn over logits, activation name) — evaluation.py:44-48."""
    if sum_model or dataset == "AIFB":
        return bce_loss, "sigmoid"
    return ce_loss, "softmax"
