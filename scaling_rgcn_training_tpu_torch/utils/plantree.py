"""Host-built edge plans as trees: frozen dataclasses whose leaves are
tensors, numpy arrays, ints and tuples of them.

Plans are built on the CPU (``ops/span_kernels.py`` ``plan_span``,
``ops/rgcn_conv.py`` ``plan_edges``, ``parallel/fused_halo.py``
``plan_fused_halo``) and moved to a device at placement
(``build_rel_edges``, ``device_put_halo_edges``,
``device_put_sharded_edges``) by :func:`to_device`, so a fresh plan and
one loaded from the plan cache (``utils/plancache.py``) take the same path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch


def map_leaves(obj: Any, fn: Callable[[Any], Any]) -> Any:
    """``obj`` rebuilt with ``fn`` applied to every tensor and array of its
    dataclasses and tuples."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: map_leaves(getattr(obj, f.name), fn)
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(map_leaves(v, fn) for v in obj)
    return obj


def to_device(plan: Any, device) -> Any:
    """The plan with every tensor on ``device`` (numpy arrays and ints as
    they are); a tensor shared by two fields stays shared."""
    device = torch.device(device)
    moved: Dict[int, torch.Tensor] = {}

    def move(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) not in moved:
            moved[id(t)] = t.to(device)
        return moved[id(t)]

    return map_leaves(plan, move)
