"""DeviceGraph: the tensors one graph trains on, on an explicit device.

Counterpart of the JAX package's ``graphs/device.py``: the span kernels'
edge plan (``ops/rgcn_conv.py`` ``build_rel_edges``) plus the split index
and label tensors. Built once per graph on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
from scaling_rgcn_training_tpu_torch.ops.span_kernels import SpanPlan


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Edges + splits for one graph. Summary graphs carry only the train split."""

    edges: SpanPlan
    x_train: torch.Tensor                    # int64 [T]  node ids with labels
    y_train: torch.Tensor                    # float32 [T, C]
    x_val: Optional[torch.Tensor] = None
    y_val: Optional[torch.Tensor] = None
    x_test: Optional[torch.Tensor] = None
    y_test: Optional[torch.Tensor] = None


def build_device_graph(graph: Graph, device) -> DeviceGraph:
    """Lower a host ``Graph`` (with training arrays attached) to ``device``."""
    edges = build_rel_edges(graph.edge_src, graph.edge_dst, graph.edge_type,
                            graph.num_nodes, graph.num_relation_slots,
                            device=device)
    idx = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.int64).to(device)
    lab = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float32).to(device)
    return DeviceGraph(
        edges=edges,
        x_train=idx(graph.x_train), y_train=lab(graph.y_train),
        x_val=idx(graph.x_val), y_val=lab(graph.y_val),
        x_test=idx(graph.x_test), y_test=lab(graph.y_test))
