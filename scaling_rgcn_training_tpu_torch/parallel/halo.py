"""Node-partitioned R-GCN aggregation with a halo exchange.

Counterpart of the JAX package's ``parallel/halo.py``. Nodes are padded to
``S * n_per`` and shard ``s`` owns rows ``[s * n_per, (s + 1) * n_per)``;
each edge lives on the owner of its ``dst``. A shard's edges split into an
owner-local segment (``src`` owned by the same shard), which reads
``x_own`` directly, and a halo segment, which reads the ``[S * H, d]``
buffer of boundary rows the other shards ship it: ``send_idx[p, s]`` are
the rows owner ``p`` ships to reader ``s``, and ``H`` the most any pair
ships. The per-(relation, dst) mean coefficients are computed globally
before partitioning (dst ownership keeps each group on one shard).

The host build (:func:`halo_partition_edges`) gives the JAX build's arrays,
``lsrc .. hgs`` and ``send_idx`` (padded as there), field by field, and
each shard's plans on the CPU: the port's span plans
(``ops/span_kernels.py``, each with its forward and backward layouts) of
the local segment and of the halo segment, which reads the received
buffer, and kernel #7's plan. None of the TPU's chunked plans is built.
With ``cache_dir`` the whole partition goes through the plan cache
(``utils/plancache.py``). :func:`device_put_halo_edges` moves the plans of
this process's shards to their mesh devices (every shard in one process).
``node_sharding`` and ``pad_node_array`` (``parallel/mesh.py``) are here
under the JAX package's names.

:func:`halo_aggregate` and :func:`halo_rgcn_conv` take this process's
node-major rows as ``parallel/mesh.py`` ``NodeRows`` (one tensor a shard,
``x_own [n_per, d]`` on its shard's device; ``k = S`` shards in one
process, ``node_sharding`` places them) and return the result the same
way, as the JAX ``shard_map`` body reads ``x_own`` where it lies and
returns ``P(EDGE_AXIS)``: inside a layer no node-major row crosses a card
but the ``S * H`` halo rows (the library exchange, #6's pulls or #7's
peer reads). The replicated parameters (``w``, ``root``, ``bias``: the
JAX ``P()``) stay on the mesh's first device and reach each shard's
through ``mesh.Replicate``, which adds their cotangents back in one fixed
order. A shard's rows on another device than its shard's raise. The
exchange of a mesh of several processes crosses them
(``parallel/ring_halo.py``, ``parallel/fused_halo.py``); one process is
the case P = 1, with its behaviour and its bits. Per shard, the span
kernels (#1, #2) aggregate where they take the widths and no ``backend``
is given (the JAX package's ``use_fused``); otherwise the edge mode
(kernels #4 and #3 with ``backend="pallas"``). On the CPU the plain
versions run. The exchange is chosen as the JAX package chooses it
(``RGCN_HALO_PALLAS_A2A``, read by :func:`exchange_mode` only):

- unset: the library exchange (``parallel/ring_halo.py``
  ``halo_exchange_library``, the counterpart of ``lax.all_to_all``);
- ``fused``: kernel #7, which exchanges and aggregates in one kernel; for
  a layer it does not cover (a ``backend``, or widths beyond the span
  kernels') a warning, then the library exchange;
- any other value: kernel #6 (``halo_exchange``).

With the library exchange or #6 the exchange overlaps the owner-local
aggregation on the cards, as the JAX package's ``shard_map`` body lets
XLA's scheduler overlap them (the counterpart of its
``async_collective_options``), in its order: the send gathers on each
card's compute stream (its current stream), the exchange on the card's
exchange stream (``ring_halo.Overlap``) once they are written, the
owner-local segment of every shard on the compute stream while the halo
rows are in flight, then the join (the compute stream waits for the
exchange stream) and the halo segments. Backward, autograd runs the
owner-local segments' backward (their nodes are younger) before the
reverse exchange, which waits for the halo segments' backward only. The
order holds where the exchange blocks the host for the other processes
(#6's host barriers, the library exchange through the host over gloo):
the owner-local backward is then queued on the card while the host
blocks in the reverse exchange. ``RGCN_HALO_BLOCK_OVERLAP``
(:func:`overlap_blocked`, a measuring arm: ``measure_overlap.py``) joins
before the owner-local segment, in both directions, as the JAX package's
``optimization_barrier``. On the CPU no stream exists and both arms run
the same ops in the same order. Kernel #7 exchanges and aggregates in one
kernel and reads no barrier. Every arm gives the same bits: the weight's
cotangents of the shards' segments are added in one fixed order
(:class:`SegmentWeights`), and each ``x_own`` collects two (its local
segment's and its send gather's), whose sum does not depend on their
order.

A kernel that fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.ops import span_kernels
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    RelEdges, RGCNLayer, materialize_weight, plan_edges, relational_aggregate)
from scaling_rgcn_training_tpu_torch.ops.segment_kernels import segment_rowptr
from scaling_rgcn_training_tpu_torch.ops.span_kernels import SpanPlan, fused_ok
from scaling_rgcn_training_tpu_torch.parallel.fused_halo import (
    FusedHaloPlan, fused_halo_apply, plan_fused_halo)
from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    Mesh, NodeRows, replicate)
# here under the JAX package's names (its parallel/halo.py)
from scaling_rgcn_training_tpu_torch.parallel.mesh import (  # noqa: F401
    node_sharding, pad_node_array)
from scaling_rgcn_training_tpu_torch.parallel.ring_halo import (
    HaloExchange, Overlap, on_cards, send_transpose)
from scaling_rgcn_training_tpu_torch.utils.plancache import get_or_build
from scaling_rgcn_training_tpu_torch.utils.plantree import to_device

EXCHANGE_ENV = "RGCN_HALO_PALLAS_A2A"
BLOCK_OVERLAP_ENV = "RGCN_HALO_BLOCK_OVERLAP"


@dataclasses.dataclass(frozen=True)
class HaloShard:
    """One shard's plans, on its device: ``local`` (src, dst in
    ``[0, n_per)``), ``halo`` (dst in ``[0, n_per)``, src in the received
    ``[S * H]`` buffer), ``send_idx [S * H]`` (int64, the rows it ships,
    reader-major: the JAX plan's ``send_idx[s]``), ``fused`` (kernel
    #7's plan), and the CSR of ``send_idx`` for the send gather's
    transpose: ``send_perm`` (int32, the slots of ``send_idx`` that a
    reader's halo edges read, sorted by their row; the padding slots,
    whose cotangents are zero, are left out) and ``send_rowptr [n_per +
    1]`` (int32). A row shipped to several readers gets their cotangents
    summed in that fixed order by the segment sum (#3), so the backward
    gives the same bits on every run (the atomic ``index_add`` does
    not)."""

    local: RelEdges
    halo: RelEdges
    send_idx: torch.Tensor
    fused: FusedHaloPlan
    send_perm: torch.Tensor
    send_rowptr: torch.Tensor


class SendGather(torch.autograd.Function):
    """``x_own[send_idx]``, the rows a shard ships, whose backward sums
    each row's cotangents through the plan's CSR
    (``ring_halo.send_transpose``)."""

    @staticmethod
    def forward(ctx, x_own, shard):
        ctx.shard = shard
        return x_own.index_select(0, shard.send_idx)

    @staticmethod
    def backward(ctx, g):
        return send_transpose(g, ctx.shard).to(g.dtype), None


def segment_weights(w: torch.Tensor, devices) -> Tuple[torch.Tensor, ...]:
    """``w`` as the S shards' owner-local and halo segments read it (the
    shards on ``devices``): ``2S`` tensors, the local segments' first, each
    on its shard's device (``mesh.replicate``). Backward: their cotangents
    added in one fixed order, the order in which autograd added them when
    each shard's ``local + halo`` ran in turn (shard S - 1 first, its halo
    segment's before its local's), so every arm and every issue order
    gives those bits; a shard on another device than ``w``'s adds its two
    there first."""
    s_n = len(devices)
    order = [i for s in reversed(range(s_n)) for i in (s_n + s, s)]
    return replicate(w, (*devices, *devices), order)


@dataclasses.dataclass(frozen=True)
class HaloShardedEdges:
    """The partition plan. Host arrays (numpy, the JAX build's layout,
    leading axis the shard): the owner-local segment ``lsrc``/``ldst``/
    ``lnorm`` ``[S, E_loc]`` and ``lgs [S, slots]``, the halo segment
    ``hsrc``/``hdst``/``hnorm`` ``[S, E_halo]`` and ``hgs``, each
    (relation, dst)-sorted and padded with ``norm = 0`` rows in the last
    relation slot; ``send_idx [S, S, H]``. ``shards``: each shard's plans,
    on the CPU until :func:`device_put_halo_edges` places them."""

    lsrc: np.ndarray
    ldst: np.ndarray
    lnorm: np.ndarray
    lgs: np.ndarray
    hsrc: np.ndarray
    hdst: np.ndarray
    hnorm: np.ndarray
    hgs: np.ndarray
    send_idx: np.ndarray
    num_nodes: int
    n_per: int
    halo: int
    num_shards: int
    num_slots: int
    shards: Tuple[HaloShard, ...] = ()


def _sorted_padded_segment(src, dst, typ, norm, num_slots, pad_len):
    """(relation, dst)-sort one edge segment and pad to ``pad_len`` rows."""
    order = np.lexsort((dst, typ))
    ne = len(src)
    o_src = np.zeros(pad_len, np.int32)
    o_dst = np.zeros(pad_len, np.int32)
    o_norm = np.zeros(pad_len, np.float32)
    o_src[:ne] = src[order]
    o_dst[:ne] = dst[order]
    o_norm[:ne] = norm[order]
    gs = np.bincount(typ, minlength=num_slots).astype(np.int32)
    gs[num_slots - 1] += pad_len - ne          # padding rows -> empty slot
    return o_src, o_dst, o_norm, gs


def halo_partition_edges(edge_src: np.ndarray, edge_dst: np.ndarray,
                         edge_type: np.ndarray, num_nodes: int,
                         num_slots: int, num_shards: int,
                         pad_to_multiple: int = 512,
                         halo_multiple: int = 8,
                         cache_dir: Optional[str] = None) -> HaloShardedEdges:
    """Host-side, once per graph: the dst-owner partition and the halo
    exchange plan, as the JAX package's ``_halo_partition_edges_host``,
    with each shard's plans on the CPU. ``cache_dir``: keep and reuse the
    partition on disk (``utils/plancache.py``)."""
    arrays = tuple(np.asarray(a, np.int32)
                   for a in (edge_src, edge_dst, edge_type))
    return get_or_build(
        cache_dir, "haloedges", arrays,
        (int(num_nodes), int(num_slots), int(num_shards),
         int(pad_to_multiple), int(halo_multiple), span_kernels.DW_CHUNK),
        lambda: _halo_partition_edges_host(
            *arrays, num_nodes, num_slots, num_shards, pad_to_multiple,
            halo_multiple),
        (HaloShardedEdges, HaloShard, RelEdges, SpanPlan, FusedHaloPlan))


def _halo_partition_edges_host(edge_src, edge_dst, edge_type, num_nodes,
                               num_slots, num_shards, pad_to_multiple,
                               halo_multiple) -> HaloShardedEdges:
    s_n = num_shards
    n_per = -(-num_nodes // s_n)

    keys = edge_type.astype(np.int64) * num_nodes + edge_dst.astype(np.int64)
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    norm_all = (1.0 / counts[inv.reshape(-1)]).astype(np.float32)

    owner = edge_dst // n_per
    need = [[None] * s_n for _ in range(s_n)]
    shards = []
    for s in range(s_n):
        m = owner == s
        src_s, dst_s, typ_s, norm_s = (edge_src[m], edge_dst[m],
                                       edge_type[m], norm_all[m])
        src_owner = src_s // n_per
        own = src_owner == s
        shards.append((src_s, dst_s, typ_s, norm_s, src_owner, own))
        for p in range(s_n):
            need[s][p] = np.unique(src_s[src_owner == p]) if p != s else \
                np.empty(0, np.int64)

    h = max((len(need[s][p]) for s in range(s_n) for p in range(s_n)),
            default=0)
    h = max(halo_multiple, -(-h // halo_multiple) * halo_multiple)

    pad = lambda ne: max(pad_to_multiple,
                         -(-ne // pad_to_multiple) * pad_to_multiple)
    e_loc = pad(max(int(sh[5].sum()) for sh in shards))
    e_halo = pad(max(len(sh[0]) - int(sh[5].sum()) for sh in shards))

    lsrc = np.zeros((s_n, e_loc), np.int32)
    ldst = np.zeros((s_n, e_loc), np.int32)
    lnorm = np.zeros((s_n, e_loc), np.float32)
    lgs = np.zeros((s_n, num_slots), np.int32)
    hsrc = np.zeros((s_n, e_halo), np.int32)
    hdst = np.zeros((s_n, e_halo), np.int32)
    hnorm = np.zeros((s_n, e_halo), np.float32)
    hgs = np.zeros((s_n, num_slots), np.int32)
    send_idx = np.zeros((s_n, s_n, h), np.int32)
    for s in range(s_n):
        src_s, dst_s, typ_s, norm_s, src_owner, own = shards[s]
        # owner-local segment: src indexes x_own directly
        l_src = (src_s[own] - s * n_per).astype(np.int32)
        l_dst = (dst_s[own] - s * n_per).astype(np.int32)
        lsrc[s], ldst[s], lnorm[s], lgs[s] = _sorted_padded_segment(
            l_src, l_dst, typ_s[own], norm_s[own], num_slots, e_loc)
        # halo segment: src indexes the received [S*H] buffer at p*H + pos
        rem = ~own
        loc = np.zeros(int(rem.sum()), np.int32)
        r_src, r_owner = src_s[rem], src_owner[rem]
        for p in range(s_n):
            if p == s:
                continue
            ids = need[s][p]                     # sorted unique remote srcs
            send_idx[p, s, :len(ids)] = ids - p * n_per
            sel = r_owner == p
            if sel.any():
                loc[sel] = p * h + np.searchsorted(ids, r_src[sel])
        h_dst = (dst_s[rem] - s * n_per).astype(np.int32)
        hsrc[s], hdst[s], hnorm[s], hgs[s] = _sorted_padded_segment(
            loc, h_dst, typ_s[rem], norm_s[rem], num_slots, e_halo)
    edges = HaloShardedEdges(
        lsrc=lsrc, ldst=ldst, lnorm=lnorm, lgs=lgs, hsrc=hsrc, hdst=hdst,
        hnorm=hnorm, hgs=hgs, send_idx=send_idx, num_nodes=int(num_nodes),
        n_per=int(n_per), halo=int(h), num_shards=int(s_n),
        num_slots=int(num_slots))
    return dataclasses.replace(edges, shards=_shard_plans(edges))


def _segment_typ(gs: np.ndarray, length: int) -> np.ndarray:
    """Per-row relation of a padded segment from its group sizes."""
    return np.repeat(np.arange(len(gs), dtype=np.int32), gs)[:length]


def _shard_plans(edges: HaloShardedEdges) -> Tuple[HaloShard, ...]:
    """Each shard's plans on the CPU (padding rows, ``norm = 0``, left
    out)."""
    s_n, n_per, h = edges.num_shards, edges.n_per, edges.halo
    slots = edges.num_slots
    # read[p, s * H + j]: reader s's halo edges read row j of what p ships
    read = np.zeros((s_n, s_n * h), bool)
    for s in range(s_n):
        loc = np.unique(edges.hsrc[s][edges.hnorm[s] > 0])
        read[loc // h, s * h + loc % h] = True
    shards = []
    for s in range(s_n):
        l_real = edges.lnorm[s] > 0
        h_real = edges.hnorm[s] > 0
        l_typ = _segment_typ(edges.lgs[s], edges.lsrc.shape[1])[l_real]
        h_typ = _segment_typ(edges.hgs[s], edges.hsrc.shape[1])[h_real]
        l_src, l_dst, l_norm = (a[s][l_real] for a in
                                (edges.lsrc, edges.ldst, edges.lnorm))
        h_loc, h_dst, h_norm = (a[s][h_real] for a in
                                (edges.hsrc, edges.hdst, edges.hnorm))
        # kernel #7 reads a halo edge's row where its owner keeps it
        peer = h_loc // h
        h_glob = peer * n_per + edges.send_idx[peer, s, h_loc % h]
        send = edges.send_idx[s].reshape(-1)
        used = np.flatnonzero(read[s])
        send_perm = used[np.argsort(send[used], kind="stable")]
        shards.append(HaloShard(
            local=plan_edges(l_src, l_dst, l_typ, l_norm, n_per, slots),
            halo=plan_edges(h_loc, h_dst, h_typ, h_norm, n_per, slots,
                            num_src=s_n * h),
            send_idx=torch.as_tensor(send, dtype=torch.int64),
            send_perm=torch.as_tensor(send_perm, dtype=torch.int32),
            send_rowptr=torch.as_tensor(segment_rowptr(send[send_perm],
                                                       n_per)),
            fused=plan_fused_halo(
                s, np.concatenate([l_src + s * n_per, h_glob]),
                np.concatenate([l_dst, h_dst]), np.concatenate([l_typ, h_typ]),
                np.concatenate([l_norm, h_norm]), edges.send_idx[:, s],
                n_per, h, s_n, slots)))
    return tuple(shards)


def device_put_halo_edges(edges: HaloShardedEdges,
                          mesh: Mesh) -> HaloShardedEdges:
    """The plans of this process's shards (``mesh.first_shard`` on, every
    shard in one process) on their mesh devices; the others' are
    dropped."""
    if mesh.size != edges.num_shards:
        raise ValueError(f"plan has {edges.num_shards} shards, mesh "
                         f"{mesh.size} devices")
    mine = edges.shards[mesh.first_shard:mesh.first_shard + mesh.local_size]
    return dataclasses.replace(edges, shards=tuple(
        to_device(sh, dev) for sh, dev in zip(mine, mesh.devices)))


def padded_num_nodes(edges: HaloShardedEdges) -> int:
    return edges.n_per * edges.num_shards


def exchange_mode() -> Optional[str]:
    """``RGCN_HALO_PALLAS_A2A``: None (unset: the library exchange),
    ``"fused"`` (kernel #7) or ``"kernel"`` (any other value: #6)."""
    value = os.environ.get(EXCHANGE_ENV)
    if not value:
        return None
    return "fused" if value == "fused" else "kernel"


def overlap_blocked() -> bool:
    """``RGCN_HALO_BLOCK_OVERLAP`` set (non-empty): the blocked arm, the
    join before the owner-local segment (a measuring arm)."""
    return bool(os.environ.get(BLOCK_OVERLAP_ENV))


def exchange_name() -> str:
    """The exchange :func:`exchange_mode` picks, as the records name it:
    ``library``, ``#6`` or ``#7``."""
    return {None: "library", "kernel": "#6", "fused": "#7"}[exchange_mode()]


def _require_rows(x) -> None:
    if not isinstance(x, NodeRows):
        raise TypeError(f"the halo conv takes node-sharded rows (NodeRows: "
                        f"mesh.node_sharding or mesh.shard_rows), got "
                        f"{type(x).__name__}")


def halo_aggregate(x: NodeRows, w: torch.Tensor, edges: HaloShardedEdges,
                   mesh: Mesh, backend: Optional[str] = None) -> NodeRows:
    """``sum_e norm_e * (x[src_e] @ w[rel_e])`` onto ``dst_e``, shard by
    shard: this process's rows ``x`` (``NodeRows`` of ``[n_per, d_in]``,
    each on its shard's device) -> the same shards' ``[n_per, d_out]``
    float32, each on its shard's device."""
    n_per = edges.n_per
    _require_rows(x)
    if mesh.size != edges.num_shards or \
            len(edges.shards) != mesh.local_size or \
            edges.shards[0].fused.shard != mesh.first_shard:
        raise ValueError("halo edges must be placed on this mesh "
                         "(device_put_halo_edges)")
    x.check(mesh)
    if x.n_per != n_per:
        raise ValueError(f"x has {x.n_per} rows a shard, the partition "
                         f"{n_per}")
    slots, d_in, d_out = w.shape
    use_span = fused_ok(d_in, d_out) and backend is None
    mode = exchange_mode()
    if mode == "fused" and not use_span:
        warnings.warn(
            f"{EXCHANGE_ENV}=fused requested, but kernel #7 does not take "
            f"this layer (d_in {d_in}, d_out {d_out}, backend {backend!r}); "
            "taking the library exchange", stacklevel=2)
        mode = None
    xs = [p.contiguous() for p in x.parts]
    w = w.contiguous()
    if mode == "fused":
        aggs = fused_halo_apply(xs, replicate(w, x.devices), edges.shards,
                                mesh if mesh.multiprocess else None)
    else:
        aggs = _exchanged_aggregate(xs, w, edges, mesh, mode or "library",
                                    "fused" if use_span else "edge", backend)
    return NodeRows(tuple(aggs))


def _exchanged_aggregate(xs: List[torch.Tensor], w: torch.Tensor,
                         edges: HaloShardedEdges, mesh: Mesh, mode: str,
                         agg_mode: str, backend: Optional[str]
                         ) -> List[torch.Tensor]:
    """Each shard's ``local + halo`` aggregation around the library
    exchange or #6, the exchange overlapping the owner-local segments on
    the cards (the module's docstring)."""
    s_n, h, d_in = edges.num_shards, edges.halo, w.shape[1]
    views = segment_weights(w, [x.device for x in xs])
    w_local, w_halo = views[:len(xs)], views[len(xs):]
    sends = [SendGather.apply(xs[s], sh).view(s_n, h, d_in)
             for s, sh in enumerate(edges.shards)]
    overlap = Overlap.on([x.device for x in xs], overlap_blocked()) \
        if on_cards(xs) else None
    across = mesh if mesh.multiprocess else None
    if overlap is None:
        recvs = HaloExchange.apply(mode, across, None, *sends)
    else:
        with overlap.issue():
            recvs = HaloExchange.apply(mode, across, overlap, *sends)
        if overlap.blocked:
            overlap.join()
    local = [relational_aggregate(x, wl, sh.local, agg_mode, backend)
             for x, wl, sh in zip(xs, w_local, edges.shards)]
    if overlap is not None and not overlap.blocked:
        overlap.join()
    return [loc + relational_aggregate(recv.reshape(s_n * h, d_in), wh,
                                       sh.halo, agg_mode, backend)
            for loc, recv, wh, sh in zip(local, recvs, w_halo, edges.shards)]


def halo_rgcn_conv(x: NodeRows, edges: HaloShardedEdges, layer: RGCNLayer,
                   mesh: Mesh, backend: Optional[str] = None,
                   compute_dtype: Optional[torch.dtype] = None) -> NodeRows:
    """Node-partitioned R-GCN layer over this process's shards: ``NodeRows``
    of ``[n_per, in]`` -> of ``[n_per, out]``, each shard on its device.

    Same math as ``ops/rgcn_conv.py`` ``rgcn_conv``. ``compute_dtype``
    (e.g. ``torch.bfloat16``): the per-edge streams, the exchanged rows
    included, run in that dtype while every sum and the output stay
    float32; the root and bias term stays in the parameters' float32 and
    runs per shard on its device (the JAX body's node-local term)."""
    w = materialize_weight(layer)
    cast = (lambda t: t) if compute_dtype is None else (
        lambda t: t.to(compute_dtype))
    _require_rows(x)
    agg = halo_aggregate(x.map(cast), cast(w), edges, mesh, backend=backend)
    roots = replicate(layer.root, x.devices)
    biases = replicate(layer.bias, x.devices)
    return NodeRows(tuple(a + xo @ r + b for a, xo, r, b in
                          zip(agg.parts, x.parts, roots, biases)))
