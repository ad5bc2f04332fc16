"""The baseline (summation) head, the reference's ``Emb_Layers``: the
trained embedding ``[N, d]``, N(0, 1) at the start, feeds the trunk."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from rgcn_bench.reference import rgcn

# comparison leaves split out of a parameter (none here)
SPLITS: Dict[str, tuple] = {}


def init_params(config: Dict[str, Any], gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    n, d = config["num_entities"], config["emb_dim"]
    params = {"embedding": torch.randn((n, d), generator=gen, device=device)}
    trunk = rgcn.trunk_module(config)
    params.update(trunk.init_params(config, gen, device))
    return params


def front(params, config, precision, dropout_masks=None) -> torch.Tensor:
    return params["embedding"]


def flops(config: Dict[str, Any], n: int) -> Tuple[int, int]:
    """``(forward, backward)`` FLOPs of the head in front of the trunk over
    ``n`` nodes: none (the embedding is read as it is)."""
    return 0, 0


def param_elements(config: Dict[str, Any], n: int) -> Dict[str, int]:
    """The head's parameter elements by top-level name."""
    return {"embedding": n * config["emb_dim"]}
