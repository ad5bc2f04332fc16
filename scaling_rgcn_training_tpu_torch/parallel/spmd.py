"""Edge-partitioned R-GCN aggregation over a mesh.

Counterpart of the JAX package's ``parallel/spmd.py``: the globally
(relation, dst)-sorted edge list is cut into ``num_shards`` contiguous
chunks of equal padded size (:func:`shard_rel_edges`, the JAX build's
arrays, with each chunk's edge-mode layouts on the CPU, through the plan
cache with ``cache_dir``; :func:`device_put_sharded_edges` moves each to
its mesh device); each shard aggregates its chunk from the whole feature
table with the port's edge-mode aggregate, and the partial ``[N, h]`` sums are
added (the JAX package's ``psum``) on the mesh's first device, from which
every shard reads the next layer's input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    RelEdges, RGCNLayer, materialize_weight, plan_edges, relational_aggregate)
from scaling_rgcn_training_tpu_torch.parallel.mesh import Mesh
from scaling_rgcn_training_tpu_torch.utils.plancache import get_or_build
from scaling_rgcn_training_tpu_torch.utils.plantree import to_device


@dataclasses.dataclass(frozen=True)
class ShardedRelEdges:
    """Host arrays ``src``/``dst``/``norm`` ``[S, E_shard]`` and
    ``group_sizes [S, slots]`` (the JAX build's: padding rows carry
    ``norm = 0`` and sit in the last relation slot); ``shards``: each
    chunk's edge-mode layouts, on the CPU until
    :func:`device_put_sharded_edges` places them."""

    src: np.ndarray
    dst: np.ndarray
    norm: np.ndarray
    group_sizes: np.ndarray
    num_nodes: int
    num_shards: int
    num_slots: int
    shards: Tuple[RelEdges, ...] = ()


def shard_rel_edges(edge_src: np.ndarray, edge_dst: np.ndarray,
                    edge_type: np.ndarray, num_nodes: int, num_slots: int,
                    num_shards: int, pad_to_multiple: int = 512,
                    cache_dir: Optional[str] = None) -> ShardedRelEdges:
    """Host-side: sort globally, normalize, cut into equal padded shards,
    and each chunk's edge-mode layouts on the CPU. ``cache_dir``: keep and
    reuse the partition on disk (``utils/plancache.py``)."""
    arrays = tuple(np.asarray(a, np.int32)
                   for a in (edge_src, edge_dst, edge_type))
    return get_or_build(
        cache_dir, "shardededges", arrays,
        (int(num_nodes), int(num_slots), int(num_shards),
         int(pad_to_multiple)),
        lambda: _shard_rel_edges_host(*arrays, num_nodes, num_slots,
                                      num_shards, pad_to_multiple),
        (ShardedRelEdges, RelEdges))


def _shard_rel_edges_host(edge_src, edge_dst, edge_type, num_nodes,
                          num_slots, num_shards,
                          pad_to_multiple) -> ShardedRelEdges:
    e = edge_src.shape[0]

    order = np.lexsort((edge_dst, edge_type))
    src, dst, typ = edge_src[order], edge_dst[order], edge_type[order]

    keys = typ.astype(np.int64) * num_nodes + dst.astype(np.int64)
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    norm = (1.0 / counts[inv.reshape(-1)]).astype(np.float32)

    per = -(-e // num_shards)
    per = max(pad_to_multiple, -(-per // pad_to_multiple) * pad_to_multiple)

    s_src = np.zeros((num_shards, per), np.int32)
    s_dst = np.zeros((num_shards, per), np.int32)
    s_norm = np.zeros((num_shards, per), np.float32)
    s_gs = np.zeros((num_shards, num_slots), np.int32)
    for s in range(num_shards):
        lo, hi = s * per, min(e, (s + 1) * per)
        n = max(0, hi - lo)
        if n:
            s_src[s, :n] = src[lo:hi]
            s_dst[s, :n] = dst[lo:hi]
            s_norm[s, :n] = norm[lo:hi]
            s_gs[s] = np.bincount(typ[lo:hi], minlength=num_slots)
        s_gs[s, num_slots - 1] += per - n  # padding rows -> empty slot
    shards = []
    for s in range(num_shards):
        # each chunk's layouts, padding rows left out
        real = s_norm[s] > 0
        s_typ = np.repeat(np.arange(num_slots, dtype=np.int32),
                          s_gs[s])[:per][real]
        shards.append(plan_edges(s_src[s][real], s_dst[s][real], s_typ,
                                 s_norm[s][real], num_nodes, num_slots,
                                 span=False))
    return ShardedRelEdges(
        src=s_src, dst=s_dst, norm=s_norm, group_sizes=s_gs,
        num_nodes=int(num_nodes), num_shards=int(num_shards),
        num_slots=int(num_slots), shards=tuple(shards))


def device_put_sharded_edges(edges: ShardedRelEdges,
                             mesh: Mesh) -> ShardedRelEdges:
    """Each chunk's edge-mode layouts on its mesh device (one process: the
    edge partition across processes is not ported)."""
    if mesh.multiprocess:
        raise NotImplementedError("the edge partition runs in one process; "
                                  "across processes take the halo partition")
    if mesh.size != edges.num_shards:
        raise ValueError(f"plan has {edges.num_shards} shards, mesh "
                         f"{mesh.size} devices")
    return dataclasses.replace(edges, shards=tuple(
        to_device(sh, dev) for sh, dev in zip(edges.shards, mesh.devices)))


def sharded_aggregate(x: torch.Tensor, w: torch.Tensor, edges: ShardedRelEdges,
                      mesh: Mesh, backend: Optional[str] = None) -> torch.Tensor:
    """The sum over shards of each chunk's partial aggregation
    ``[N, d_out]`` (float32), on the mesh's first device."""
    if not edges.shards or mesh.size != edges.num_shards:
        raise ValueError("sharded edges must be placed on this mesh "
                         "(device_put_sharded_edges)")
    x, w = x.contiguous(), w.contiguous()
    total = None
    for sh, dev in zip(edges.shards, mesh.devices):
        part = relational_aggregate(x.to(dev), w.to(dev), sh, "edge",
                                    backend).to(mesh.first)
        total = part if total is None else total + part
    return total


def sharded_rgcn_conv(x: torch.Tensor, edges: ShardedRelEdges,
                      layer: RGCNLayer, mesh: Mesh,
                      backend: Optional[str] = None,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The R-GCN layer over partitioned edges (same math as
    ``ops/rgcn_conv.py`` ``rgcn_conv``); ``compute_dtype``: low-precision
    per-edge streams, float32 sums and output."""
    w = materialize_weight(layer)
    cast = (lambda t: t) if compute_dtype is None else (
        lambda t: t.to(compute_dtype))
    agg = sharded_aggregate(cast(x), cast(w), edges, mesh, backend=backend)
    return agg + x @ layer.root + layer.bias
