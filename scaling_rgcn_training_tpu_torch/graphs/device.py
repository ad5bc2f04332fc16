"""DeviceGraph: the tensors one graph trains on, on an explicit device.

Counterpart of the JAX package's ``graphs/device.py``: the conv's edge
layouts (``ops/rgcn_conv.py`` ``build_rel_edges``, span plan included, or
a partition over a mesh) plus the split index and label tensors. Built
once per graph on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
from scaling_rgcn_training_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Edges + splits for one graph. Summary graphs carry only the train split.

    ``node_perm`` (halo partition with a locality reorder only):
    ``node_perm[old_id] = new_id``; the split index tensors are already
    remapped, and embeddings entering or leaving the model go through it
    (``train/trainer.py``)."""

    edges: Any                               # RelEdges, or a partition (parallel/)
    x_train: torch.Tensor                    # int64 [T]  node ids with labels
    y_train: torch.Tensor                    # float32 [T, C]
    x_val: Optional[torch.Tensor] = None
    y_val: Optional[torch.Tensor] = None
    x_test: Optional[torch.Tensor] = None
    y_test: Optional[torch.Tensor] = None
    node_perm: Optional[np.ndarray] = None


def build_device_graph(graph: Graph, device, mesh=None,
                       partition: Optional[str] = None,
                       reorder: bool = False,
                       plan_cache: Optional[str] = None) -> DeviceGraph:
    """Lower a host ``Graph`` (with training arrays attached) to ``device``.

    With ``mesh`` (``parallel/mesh.py``) and ``partition`` (``"edge"`` or
    ``"halo"``) the edges are partitioned across the mesh instead, and
    ``rgcn_conv`` dispatches on their type, so models and the trainer run
    unchanged. ``reorder`` (halo only): relabel nodes by label-propagation
    clustering (``parallel/reorder.py``) before partitioning, which shrinks
    the halo exchange on community-structured graphs; ``node_perm`` keeps
    the relabeling. On a mesh of several processes every process builds
    (or loads) the plan of all ``mesh.size`` shards and places only its
    own. ``plan_cache``: a directory where the edge plans are kept and
    reused (``utils/plancache.py``). Runs in the recorder's ``plan`` span
    (``utils/tracing.py``), the placement on ``device`` in ``plan.place``
    spans."""
    with span("plan"):
        return _build_device_graph(graph, device, mesh, partition, reorder,
                                   plan_cache)


def _build_device_graph(graph: Graph, device, mesh, partition: Optional[str],
                        reorder: bool, plan_cache: Optional[str]
                        ) -> DeviceGraph:
    idx = lambda a: None if a is None else torch.as_tensor(
        np.asarray(a), dtype=torch.int64).to(device)
    lab = lambda a: None if a is None else torch.as_tensor(
        a, dtype=torch.float32).to(device)
    node_perm = None
    remap = lambda a: a
    if mesh is not None and partition:
        src, dst = graph.edge_src, graph.edge_dst
        if reorder and partition == "halo":
            from scaling_rgcn_training_tpu_torch.parallel.reorder import (
                locality_reorder)

            node_perm = locality_reorder(src, dst, graph.num_nodes,
                                         num_shards=mesh.size)
            src, dst = node_perm[src], node_perm[dst]
            remap = lambda a: None if a is None else node_perm[np.asarray(a)]
        if partition == "edge":
            from scaling_rgcn_training_tpu_torch.parallel.spmd import (
                device_put_sharded_edges, shard_rel_edges)

            plan = shard_rel_edges(
                src, dst, graph.edge_type, graph.num_nodes,
                graph.num_relation_slots, mesh.size, cache_dir=plan_cache)
            with span("plan.place"):
                edges = device_put_sharded_edges(plan, mesh)
        elif partition == "halo":
            from scaling_rgcn_training_tpu_torch.parallel.halo import (
                device_put_halo_edges, halo_partition_edges)

            plan = halo_partition_edges(
                src, dst, graph.edge_type, graph.num_nodes,
                graph.num_relation_slots, mesh.size, cache_dir=plan_cache)
            with span("plan.place"):
                edges = device_put_halo_edges(plan, mesh)
        else:
            raise ValueError(f"unknown partition {partition!r}")
    else:
        edges = build_rel_edges(graph.edge_src, graph.edge_dst,
                                graph.edge_type, graph.num_nodes,
                                graph.num_relation_slots, device=device,
                                cache_dir=plan_cache)
    with span("plan.place"):
        return DeviceGraph(
            edges=edges,
            x_train=idx(remap(graph.x_train)), y_train=lab(graph.y_train),
            x_val=idx(remap(graph.x_val)), y_val=lab(graph.y_val),
            x_test=idx(remap(graph.x_test)), y_test=lab(graph.y_test),
            node_perm=node_perm)


def model_num_nodes(dev_graph: DeviceGraph) -> int:
    """Rows of the node table a model allocates for this graph: the halo
    partition pads nodes to ``num_shards * n_per`` (the phantom rows get
    no edges and no labels); otherwise the graph's node count."""
    edges = dev_graph.edges
    if type(edges).__name__ == "HaloShardedEdges":
        return edges.n_per * edges.num_shards
    return edges.num_nodes
