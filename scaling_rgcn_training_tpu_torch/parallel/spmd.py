"""Edge-partitioned R-GCN aggregation over a mesh, in one process or
across several.

Counterpart of the JAX package's ``parallel/spmd.py``: the globally
(relation, dst)-sorted edge list is cut into ``num_shards`` contiguous
chunks of equal padded size (:func:`shard_rel_edges`, the JAX build's
arrays, with each chunk's edge-mode layouts on the CPU, through the plan
cache with ``cache_dir``; :func:`device_put_sharded_edges` moves this
process's chunks to its mesh devices). Each shard aggregates its chunk
from the whole, replicated feature table with the port's edge-mode
aggregate, and the partial ``[N, h]`` float32 sums are added in global
shard order (the JAX package's ``psum``): in one process on the mesh's
first device; across processes every process gathers every process's
partials and adds them in that same order, so every process holds the
same bits of the sum (:class:`SumShards`).

The backward follows ``shard_map``'s rules for replicated (``P()``)
operands: each shard's partial takes the sum's whole cotangent, and each
shard's cotangents of ``x`` and ``w`` are added over every shard of the
mesh in global shard order (:class:`ShardInputs`, the psum XLA puts on a
``P()`` input's cotangent; across processes this process's per-shard
cotangents are gathered from every process). One process adds them in
the same order, so one process and any number of processes hold the same
bits, step after step. Everything outside the aggregation (the root
term, activations, loss, optimizer) runs identically on every process on
replicated tensors, so its gradients are already whole: they are not
summed again. :data:`CROSS_SUM` counts the cross-process sums and the
bytes this process contributes to them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    RelEdges, RGCNLayer, materialize_weight, plan_edges, relational_aggregate)
from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    Mesh, all_gather_tensor)
from scaling_rgcn_training_tpu_torch.utils.plancache import get_or_build
from scaling_rgcn_training_tpu_torch.utils.plantree import to_device


@dataclasses.dataclass(frozen=True)
class ShardedRelEdges:
    """Host arrays ``src``/``dst``/``norm`` ``[S, E_shard]`` and
    ``group_sizes [S, slots]`` (the JAX build's: padding rows carry
    ``norm = 0`` and sit in the last relation slot); ``shards``: each
    chunk's edge-mode layouts, on the CPU until
    :func:`device_put_sharded_edges` places them (then this process's
    chunks only)."""

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
    """This process's chunks' edge-mode layouts on its mesh devices: the
    global shards ``mesh.first_shard`` to ``mesh.first_shard + k - 1`` of
    the plan every process builds (or loads from the plan cache); every
    chunk in one process."""
    if mesh.size != edges.num_shards:
        raise ValueError(f"plan has {edges.num_shards} shards, mesh "
                         f"{mesh.size} devices")
    mine = edges.shards[mesh.first_shard:mesh.first_shard + mesh.local_size]
    return dataclasses.replace(edges, shards=tuple(
        to_device(sh, dev) for sh, dev in zip(mine, mesh.devices)))


# the cross-process sums of this process: calls and the bytes it
# contributed (its shards' partials forward, their cotangents backward)
CROSS_SUM: Dict[str, int] = {"calls": 0, "bytes": 0}


def _in_shard_order(parts: Iterable[torch.Tensor]) -> torch.Tensor:
    total = None
    for part in parts:
        total = part if total is None else total + part
    return total


def sum_shards(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """One tensor of each of this process's shards (in shard order, one
    shape and dtype, on ``mesh.first``) -> their sum over every shard of
    the mesh, added in global shard order. Across processes every
    process's tensors are gathered first (one call, rank order = shard
    order), so every process adds the same tensors in the same order as
    one process running all S shards, and holds the same bits."""
    if mesh.multiprocess:
        local = torch.stack(list(parts))
        CROSS_SUM["calls"] += 1
        CROSS_SUM["bytes"] += local.numel() * local.element_size()
        parts = [p for block in all_gather_tensor(local, mesh)
                 for p in block.unbind(0)]
    return _in_shard_order(parts)


class SumShards(torch.autograd.Function):
    """:func:`sum_shards` of the shards' partial aggregations across
    processes; backward, each local partial takes the whole (replicated)
    cotangent, as ``out_specs=P()`` after a psum gives it in JAX."""

    @staticmethod
    def forward(ctx, mesh, *parts):
        ctx.num_parts = len(parts)
        return sum_shards(parts, mesh)

    @staticmethod
    def backward(ctx, g):
        return (None, *([g] * ctx.num_parts))


class ShardInputs(torch.autograd.Function):
    """The replicated ``x`` and materialised ``w`` as each of this
    process's k shards reads them: k aliases of each (the identity).
    Backward: each input's cotangent is :func:`sum_shards` of its shards'
    cotangents, the psum ``shard_map``'s transpose puts on a ``P()``
    input's cotangent. The shards' cotangents are added in one fixed
    order (global shard order) in one process as across processes, so the
    processes hold the same bits as each other and as one process running
    all S shards, step after step; autograd's own accumulation of the
    aliases would add them in the order their aggregations' backwards
    ran, interleaved with the root term's cotangent, which no grouping by
    process reproduces."""

    @staticmethod
    def forward(ctx, mesh, x, w):
        ctx.mesh = mesh
        k = mesh.local_size
        return (*(x.view_as(x) for _ in range(k)),
                *(w.view_as(w) for _ in range(k)))

    @staticmethod
    def backward(ctx, *grads):
        k = ctx.mesh.local_size
        return (None, *(sum_shards(g, ctx.mesh) if need else None
                        for need, g in zip(ctx.needs_input_grad[1:],
                                           (grads[:k], grads[k:]))))


def sharded_aggregate(x: torch.Tensor, w: torch.Tensor, edges: ShardedRelEdges,
                      mesh: Mesh, backend: Optional[str] = None) -> torch.Tensor:
    """The sum over every shard of the mesh of each chunk's partial
    aggregation ``[N, d_out]`` (float32), on ``mesh.first``; across
    processes replicated on every process (``x`` and ``w`` replicated
    too). Every process enters the same gathers, forward and backward,
    even when its shards hold only padding rows."""
    if (not edges.shards or len(edges.shards) != mesh.local_size
            or edges.num_shards != mesh.size):
        raise ValueError("sharded edges must be placed on this mesh "
                         "(device_put_sharded_edges)")
    k = mesh.local_size
    views = ShardInputs.apply(mesh, x.contiguous(), w.contiguous())
    parts = (relational_aggregate(xs.to(dev), ws.to(dev), sh, "edge",
                                  backend).to(mesh.first)
             for xs, ws, sh, dev in zip(views[:k], views[k:], edges.shards,
                                        mesh.devices))
    if mesh.multiprocess:
        return SumShards.apply(mesh, *parts)
    return _in_shard_order(parts)


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
