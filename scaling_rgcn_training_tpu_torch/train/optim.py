"""Optimizer matching the reference's ``torch.optim.Adam`` exactly.

``Adam(params, lr, weight_decay=5e-5)`` (model/modelTrainer.py:44) is the
coupled L2 the JAX package rebuilds from optax (``grad += wd * param``
before the moment updates). Frozen parameters (e_freeze / w_grad=False,
modelTrainer.py:94-105) are left out of the optimizer, so they get neither
update nor decay — what the JAX package's update mask does.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
