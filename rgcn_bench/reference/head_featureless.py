"""The featureless head of the R-GCN paper's entity classifier: no
embedding and no front; the trunk's first layer reads the node id
(``trunk_basis.py``)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from rgcn_bench.reference import rgcn

# comparison leaves split out of a parameter (none here)
SPLITS: Dict[str, tuple] = {}


def init_params(config: Dict[str, Any], gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """The trunk's parameters; the head draws none."""
    return rgcn.trunk_module(config).init_params(config, gen, device)


def front(params, config, precision, dropout_masks=None) -> None:
    return None


def flops(config: Dict[str, Any], n: int) -> Tuple[int, int]:
    """``(forward, backward)`` FLOPs of the head: none."""
    return 0, 0


def param_elements(config: Dict[str, Any], n: int) -> Dict[str, int]:
    """The head's parameter elements: none."""
    return {}
