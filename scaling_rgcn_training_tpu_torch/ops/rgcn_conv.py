"""The per-relation graph convolution (R-GCN message passing) in PyTorch.

The math of PyG ``RGCNConv`` as the reference uses it (model/layers.py:
15-16,21-23 with ``aggr='mean'``, ``root_weight=True``, ``bias=True``):

    out_i = x_i @ root + bias + sum_r ( mean_{j in N_r(i)} x_j ) @ weight[r]

Counterpart of the JAX package's ``ops/rgcn_conv.py``. The message-passing
sum ``relational_aggregate`` has three dataflows, each a
``torch.autograd.Function`` with a hand-written backward:

- ``fused``: the span kernels (``ops/span_kernels.py``) gather, transform
  and sum in one pass each way; they take layers up to their width limit;
- ``edge``: gather ``x[src]``, one grouped matmul over the
  relation-contiguous edges (``ops/grouped_matmul.py``), and sum onto
  ``dst`` with the sorted segment sum (``ops/segment_kernels.py``), which
  gathers the messages into dst order through ``dst_perm`` and scales them
  by ``norm`` as it reads them;
- ``prematmul``: ``Z = x @ W`` for every relation first, then gather
  ``Z[src, rel]`` and sum as ``edge`` does.

The backward of ``edge`` and ``prematmul`` is the JAX package's large-N
backward: ``g_msg = g_out[dst] * norm``, ``dx`` by the grouped matmul on
``W^T`` and a segment sum onto src through ``src_perm``, ``dW`` by the
grouped ``d_rhs`` kernel. On the card both sums run through the
segment-sum kernel and ``dW`` through the ``d_rhs`` kernel whatever the
backend; the backend picks the grouped matmul. ``mode="auto"`` picks
``fused`` where the edges carry the span plan and the span kernels take the
widths, and otherwise the JAX package's traffic rule. ``aggr="attention"`` runs ``ops/sddmm.py``.

A layer with no input (``x=None``: a featureless first layer, which reads
the node id; a :class:`BasisLayer` over ``[N, B, out]`` bases) runs
``ops/basis_kernels.py``, which never materialises ``[R, N, out]``.

Weights keep the JAX layout ``weight [R, in, out]``, ``root [in, out]``,
``bias [out]``, so the two packages compare like with like.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from scaling_rgcn_training_tpu_torch.ops import span_kernels
from scaling_rgcn_training_tpu_torch.ops.basis_kernels import (
    basis_conv, dst_to_src_positions)
from scaling_rgcn_training_tpu_torch.ops.grouped_kernels import gmm_drhs
from scaling_rgcn_training_tpu_torch.ops.grouped_matmul import grouped_matmul
from scaling_rgcn_training_tpu_torch.ops.sddmm import attention_aggregate
from scaling_rgcn_training_tpu_torch.ops.segment_kernels import (
    segment_rowptr, sorted_segment_sum)
from scaling_rgcn_training_tpu_torch.ops.span_kernels import (
    SpanPlan, check_edges, fused_ok, plan_span, span_backward, span_forward)
from scaling_rgcn_training_tpu_torch.utils.plancache import get_or_build
from scaling_rgcn_training_tpu_torch.utils.plantree import to_device
from scaling_rgcn_training_tpu_torch.utils import tracing

# the [N * slots, d_out] table of prematmul stays below this (the JAX
# package's default; not measured on the H100 yet)
_SMALL_TABLE_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class RelEdges:
    """Edge layouts of one graph, built once on the host.

    - relation-contiguous edges, ordered by ``(rel, src)``: ``src``,
      ``dst`` (int32) and ``norm`` (float32) ``[E]``; ``group_offsets``
      (host ints ``[slots + 1]``) and ``group_sizes [slots]`` (int64) cut
      them into relations;
    - ``dst_rowptr [N + 1]`` (int32): the row pointer of the dst keys in
      sorted order; ``src_rowptr [num_src + 1]`` the same for src
      (``num_src``, the count of input rows, is N except for the halo
      partition's halo segment, which reads a received row buffer);
    - ``span``: the span kernels' plan, or None (``span=False``), which
      keeps ``mode="auto"`` off the fused dataflow. With a plan, ``src``,
      ``dst``, ``norm`` and both row pointers are the plan's own tensors.

    ``rel`` and the permutations ``dst_perm``/``src_perm`` (relation order
    -> dst- or src-sorted order) only serve the non-fused dataflows: they
    are built on the edges' device at first use, so the fused dataflow
    never holds them. ``basis_perm`` (each dst-sorted edge's position in
    the span plan's src-sorted order) likewise serves the featureless basis
    layer's kernels alone.
    """

    num_nodes: int
    num_slots: int
    num_src: int
    src: torch.Tensor
    dst: torch.Tensor
    norm: torch.Tensor
    group_sizes: torch.Tensor
    group_offsets: Tuple[int, ...]
    dst_rowptr: torch.Tensor
    src_rowptr: torch.Tensor
    span: Optional[SpanPlan] = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @functools.cached_property
    def rel(self) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(self.num_slots, dtype=torch.int32,
                         device=self.src.device),
            self.group_sizes, output_size=self.num_edges)

    @functools.cached_property
    def dst_perm(self) -> torch.Tensor:
        return torch.argsort(self.dst, stable=True).to(torch.int32)

    @functools.cached_property
    def src_perm(self) -> torch.Tensor:
        return torch.argsort(self.src, stable=True).to(torch.int32)

    @functools.cached_property
    def basis_perm(self) -> torch.Tensor:
        with tracing.span("plan.basis"):
            return dst_to_src_positions(self.span)


def plan_edges(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
               norm: np.ndarray, num_nodes: int, num_slots: int,
               span: bool = True,
               num_src: Optional[int] = None) -> RelEdges:
    """:class:`RelEdges` from per-edge ``(src, dst, rel, norm)``
    (``dst < num_nodes``, ``src < num_src``, by default ``num_nodes``);
    with ``span`` the span kernels' plan, whose relation-ordered edges and
    row pointers it shares. Built on the CPU."""
    num_src = num_nodes if num_src is None else num_src
    src, dst, rel, norm = check_edges(src, dst, rel, norm, num_nodes,
                                      num_slots, num_src)
    sizes = np.bincount(rel, minlength=num_slots)
    offsets = tuple(int(v) for v in np.concatenate([[0], np.cumsum(sizes)]))
    group_sizes = torch.as_tensor(sizes, dtype=torch.int64)
    if span:
        plan = plan_span(src, dst, rel, norm, num_nodes, num_slots,
                         num_src=num_src)
        return RelEdges(
            num_nodes=int(num_nodes), num_slots=int(num_slots),
            num_src=int(num_src), src=plan.rel_src, dst=plan.rel_dst,
            norm=plan.rel_norm, group_sizes=group_sizes, group_offsets=offsets,
            dst_rowptr=plan.fwd_rowptr, src_rowptr=plan.bwd_rowptr, span=plan)
    order = np.lexsort((src, rel))   # (rel, src), as the span plan's rel_*
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    return RelEdges(
        num_nodes=int(num_nodes), num_slots=int(num_slots),
        num_src=int(num_src), src=t(src[order]), dst=t(dst[order]),
        norm=t(norm[order]), group_sizes=group_sizes, group_offsets=offsets,
        dst_rowptr=t(segment_rowptr(np.sort(dst), num_nodes)),
        src_rowptr=t(segment_rowptr(np.sort(src), num_src)))


def build_rel_edges(edge_src: np.ndarray, edge_dst: np.ndarray,
                    edge_type: np.ndarray, num_nodes: int, num_slots: int,
                    device="cpu", span: bool = True,
                    cache_dir: Optional[str] = None) -> RelEdges:
    """Host-side edge build, once per graph: the mean coefficient
    ``norm_e = 1 / deg_r(dst_e)`` (in-degree of ``dst_e`` over edges of
    ``e``'s relation) and the edge layouts (:func:`plan_edges`), built on
    the CPU and moved to ``device``. ``cache_dir``: keep and reuse the
    plan on disk (``utils/plancache.py``). The recorder
    (``utils/tracing.py``) gets the norm's ``plan.norm`` span, the
    placement's ``plan.place`` and the counter ``plan.max_row_edges``
    (:func:`max_row_edges`), on a cache hit too."""
    src = np.asarray(edge_src, np.int32)
    dst = np.asarray(edge_dst, np.int32)
    typ = np.asarray(edge_type, np.int32)

    def build() -> RelEdges:
        with tracing.span("plan.norm"):
            keys = typ.astype(np.int64) * num_nodes + dst.astype(np.int64)
            _, inv, counts = np.unique(keys, return_inverse=True,
                                       return_counts=True)
            norm = (1.0 / counts[inv.reshape(-1)]).astype(np.float32)
        return plan_edges(src, dst, typ, norm, num_nodes, num_slots,
                          span=span)

    edges = get_or_build(
        cache_dir, "reledges", (src, dst, typ),
        (int(num_nodes), int(num_slots), bool(span), span_kernels.DW_CHUNK),
        build, (RelEdges, SpanPlan))
    tracing.count("plan.max_row_edges", max_row_edges(edges), add=False)
    with tracing.span("plan.place"):
        return to_device(edges, device)


def max_row_edges(edges: RelEdges) -> int:
    """The most edges in one row of the dst (forward) or src (backward)
    CSR: the longest row a warp of the span kernels' sums walks (#1's and
    #2's ``span_msg_sum_kernel``), from the plan's row pointers."""
    return max([int(torch.diff(ptr).max()) for ptr in
                (edges.dst_rowptr, edges.src_rowptr) if ptr.numel() > 1],
               default=0)


class RGCNLayer(nn.Module):
    """One R-GCN layer's parameters, optionally decomposed.

    - full:       ``weight [R, in, out]``, ``comp`` None
    - basis:      ``weight [B, in, out]`` (bases), ``comp [R, B]``
    - block-diag: ``weight [R, nb, in/nb, out/nb]``, ``comp`` None
    ``root [in, out]`` and ``bias [out]`` are always dense.
    """

    def __init__(self, weight: torch.Tensor, root: torch.Tensor,
                 bias: torch.Tensor, comp: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.root = nn.Parameter(root)
        self.bias = nn.Parameter(bias)
        self.comp = None if comp is None else nn.Parameter(comp)


class BasisLayer(nn.Module):
    """A featureless first layer, which reads the node id (PyG
    ``RGCNConv`` with ``x=None`` and ``num_bases``), under PyG's leaf names:
    ``bases [N, B, out]`` (PyG's ``weight[b, i]`` is ``bases[i, b]``; a
    node's ``B x out`` block is contiguous, the basis kernels' layout),
    ``comp [R, B]``, ``root [N, out]``, ``bias [out]``. Relation ``r``'s
    weight is ``sum_b comp[r, b] bases[:, b]``, never materialised
    (``rgcn_conv`` with ``x=None``). A basis layer with an input is an
    :class:`RGCNLayer` with ``comp``."""

    def __init__(self, bases: torch.Tensor, comp: torch.Tensor,
                 root: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.bases = nn.Parameter(bases)
        self.comp = nn.Parameter(comp)
        self.root = nn.Parameter(root)
        self.bias = nn.Parameter(bias)


def materialize_weight(layer: RGCNLayer) -> torch.Tensor:
    """-> dense ``[R, in, out]`` relation weights from any decomposition."""
    w = layer.weight
    if layer.comp is not None:  # basis decomposition
        return torch.einsum("rb,bio->rio", layer.comp, w)
    if w.dim() == 4:  # block-diagonal [R, nb, i/nb, o/nb] -> [R, in, out]
        r, nb, bi, bo = w.shape
        eye = torch.eye(nb, dtype=w.dtype, device=w.device)
        return torch.einsum("rbio,bc->rbico", w, eye).reshape(r, nb * bi, nb * bo)
    return w


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) float32 from ``gen``."""
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def init_rgcn_layer(gen: torch.Generator, num_slots: int, in_dim: int,
                    out_dim: int, num_bases: Optional[int] = None,
                    num_blocks: Optional[int] = None,
                    device="cpu") -> RGCNLayer:
    """Initialization matching the reference's distributions.

    - relation weights: torch ``kaiming_uniform_(mode='fan_in')`` on the
      ``[R, in, out]`` tensor (model/layers.py:17-18): bound
      ``sqrt(6 / (in * out))`` (torch's fan_in of a 3-D tensor is
      ``size(1) * prod(size()[2:])``);
    - root: PyG glorot, bound ``sqrt(6 / (in + out))``;
    - bias: zeros (PyG default).
    """
    comp = None
    if num_blocks is not None:
        if in_dim % num_blocks or out_dim % num_blocks:
            raise ValueError("block-diagonal decomposition needs in/out "
                             "divisible by num_blocks")
        w_shape = (num_slots, num_blocks, in_dim // num_blocks,
                   out_dim // num_blocks)
        fan = w_shape[1] * w_shape[2] * w_shape[3]
    elif num_bases is not None:
        w_shape = (num_bases, in_dim, out_dim)
        fan = in_dim * out_dim
        comp = uniform(gen, (num_slots, num_bases),
                        float(np.sqrt(6.0 / (num_slots + num_bases))))
    else:
        w_shape = (num_slots, in_dim, out_dim)
        fan = in_dim * out_dim
    weight = uniform(gen, w_shape, float(np.sqrt(6.0 / fan)))
    root = uniform(gen, (in_dim, out_dim), float(np.sqrt(6.0 / (in_dim + out_dim))))
    layer = RGCNLayer(weight, root, torch.zeros(out_dim), comp)
    return layer.to(device)


class _FusedAggregate(torch.autograd.Function):
    """``sum_e norm_e * (x[src_e] @ w[rel_e])`` onto dst by the span
    kernels, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.save_for_backward(x, w)
        ctx.plan = plan
        return span_forward(x, w, plan)

    @staticmethod
    def backward(ctx, g_out):
        x, w = ctx.saved_tensors
        # cast before the gather: [N, d_out] once, not [E, d_out]
        dx, dw = span_backward(g_out.to(w.dtype).contiguous(), x, w, ctx.plan)
        return dx.to(x.dtype), dw.to(w.dtype), None


class _EdgeAggregate(torch.autograd.Function):
    """The ``edge`` and ``prematmul`` dataflows (JAX ``rgcn_conv.py``
    ``_aggregate_fwd_impl`` and the large-N branch of ``_aggregate_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, edges, mode, backend):
        ctx.save_for_backward(x, w)
        ctx.edges, ctx.backend = edges, backend
        if mode == "prematmul":
            # one flat matmul [N, d] @ [d, slots * h] -> [N * slots, h] in
            # src-major layout, so the gather key is src * slots + rel
            slots, d_in, d_out = w.shape
            z = (x @ w.transpose(0, 1).reshape(d_in, slots * d_out)
                 ).reshape(-1, d_out)
            msg = z.index_select(0, edges.src.long() * slots + edges.rel)
        else:
            msg = grouped_matmul(x.index_select(0, edges.src), w,
                                 edges.group_sizes, backend=backend,
                                 static_offsets=edges.group_offsets)
        # the segment sum gathers msg into dst order and scales it by norm
        # as it reads it, and sums (and returns) f32 for low-precision msg
        return sorted_segment_sum(msg, edges.dst_rowptr, perm=edges.dst_perm,
                                  scale=edges.norm)

    @staticmethod
    def backward(ctx, g_out):
        x, w = ctx.saved_tensors
        edges = ctx.edges
        g_msg = g_out.index_select(0, edges.dst) * edges.norm[:, None]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the d_in-wide intermediate stays in w's dtype (bf16 streams
            # halve its traffic); the segment sum adds in f32
            dmsg = grouped_matmul(g_msg.to(w.dtype), w.transpose(1, 2),
                                  edges.group_sizes, backend=ctx.backend,
                                  static_offsets=edges.group_offsets)
            dx = sorted_segment_sum(dmsg, edges.src_rowptr,
                                    perm=edges.src_perm).to(x.dtype)
            # free the [E, d_in] messages before dW gathers [E, d_in] rows
            # of x: the two never live at once (the step's peak memory)
            del dmsg
        if ctx.needs_input_grad[1]:
            dw = gmm_drhs(x.index_select(0, edges.src), g_msg,
                          edges.group_sizes).to(w.dtype)
        return dx, dw, None, None, None


def relational_aggregate(x: torch.Tensor, w: torch.Tensor, edges: RelEdges,
                         mode: str = "edge",
                         backend: Optional[str] = None) -> torch.Tensor:
    """``[N, d_in] -> [N, d_out]``: ``sum_e norm_e * (x[src_e] @ w[rel_e])``
    onto ``dst_e``, by the dataflow ``mode``; float32 for float32 or
    bfloat16 inputs. ``backend`` picks the grouped matmul of ``edge`` mode
    and of both backwards."""
    x, w = x.contiguous(), w.contiguous()
    if mode == "fused":
        if edges.span is None:
            raise ValueError("mode='fused' needs edges built with span=True")
        return _FusedAggregate.apply(x, w, edges.span)
    if mode in ("edge", "prematmul"):
        return _EdgeAggregate.apply(x, w, edges, mode, backend)
    raise ValueError(f"unknown aggregation mode {mode!r}")


def _edge_traffic_mode(num_nodes: int, num_slots: int, num_edges: int,
                       d_in: int, d_out: int) -> str:
    """The JAX package's rule: ``prematmul`` moves ``4 * d_out`` bytes per
    edge at the cost of the ``[N * slots, d_out]`` table, ``edge`` about
    ``2 * (d_in + d_out)`` with no table."""
    z_bytes = num_nodes * num_slots * d_out * 4
    if d_out < d_in and z_bytes < 2 * num_edges * d_in * 4 and \
            z_bytes < _SMALL_TABLE_BYTES:
        return "prematmul"
    return "edge"


def auto_mode(edges: RelEdges, d_in: int, d_out: int) -> str:
    """``fused`` where the edges carry the span plan and the span kernels
    take the widths, else the traffic rule's ``edge`` or ``prematmul``."""
    if edges.span is not None and fused_ok(d_in, d_out):
        return "fused"
    return _edge_traffic_mode(edges.num_nodes, edges.num_slots,
                              edges.num_edges, d_in, d_out)


def rgcn_conv(x: Optional[torch.Tensor], edges: RelEdges, layer: RGCNLayer,
              backend: Optional[str] = None, mode: str = "auto",
              compute_dtype: Optional[torch.dtype] = None,
              aggr: str = "mean") -> torch.Tensor:
    """Apply one R-GCN layer: ``[N, in] -> [N, out]``.

    ``aggr``: ``"mean"`` (PyG ``RGCNConv``) or ``"attention"`` (the SDDMM,
    segment-softmax and weighted-sum pipeline of ``ops/sddmm.py``).
    ``mode``: ``"auto"`` (:func:`auto_mode`), ``"fused"``, ``"edge"`` or
    ``"prematmul"``; ``backend`` picks the grouped matmul of the non-fused
    dataflows and of attention.
    ``compute_dtype`` (e.g. ``torch.bfloat16``): the aggregation's gathers
    and products read ``x`` and the relation weights in that dtype, while
    every sum and the output stay float32; the root and bias term stays in
    the parameters' float32.

    Dispatch on the edges' type, as the JAX package does: edges
    partitioned over a mesh (``parallel/spmd.py`` ``ShardedRelEdges``,
    ``parallel/halo.py`` ``HaloShardedEdges``) run the partitioned conv
    over the ambient mesh (``parallel/mesh.py`` ``use_mesh``), so models
    never need to know whether they are distributed; ``x`` and the result
    stay one tensor (the halo conv's node-sharded rows are split from it
    and gathered back onto its device).

    ``x=None``: a featureless layer over the node id (``layer`` a
    :class:`BasisLayer` with ``[N, B, out]`` bases; mean aggregation on one
    device), ``ops/basis_kernels.py`` ``basis_conv``, in the bases'
    float32 whatever ``compute_dtype``. Its backward's end is marked
    ``trunk.grad`` on the way to ``comp`` (``utils/tracing.py``
    ``grad_mark``): the layer has no input to mark.
    """
    kind = type(edges).__name__
    if x is None:
        if not isinstance(layer, BasisLayer) or aggr != "mean" or \
                not isinstance(edges, RelEdges):
            raise ValueError("x=None takes a BasisLayer, aggr='mean' and "
                             f"single-device edges; got {type(layer).__name__}"
                             f", {kind}, aggr {aggr!r}")
        return basis_conv(edges, layer.bases,
                          tracing.grad_mark(layer.comp, "trunk.grad"),
                          layer.root, layer.bias)
    if kind in ("ShardedRelEdges", "HaloShardedEdges"):
        from scaling_rgcn_training_tpu_torch.parallel.mesh import current_mesh

        if aggr != "mean":
            raise ValueError("aggr='attention' is a single-device mode: the "
                             "partitioned convs bake the mean coefficients "
                             "into their plans")
        mesh = current_mesh()
        if mesh is None:
            raise RuntimeError(f"rgcn_conv got {kind} outside a "
                               "parallel.mesh.use_mesh(...) scope")
        if kind == "HaloShardedEdges":
            # the caller keeps one tensor of the rows on the mesh's first
            # device: split into the node-sharded layout and gathered back
            from scaling_rgcn_training_tpu_torch.parallel.halo import (
                halo_rgcn_conv)
            from scaling_rgcn_training_tpu_torch.parallel.mesh import (
                shard_rows)

            return halo_rgcn_conv(
                shard_rows(x, mesh), edges, layer, mesh, backend=backend,
                compute_dtype=compute_dtype).gather(x.device)
        from scaling_rgcn_training_tpu_torch.parallel.spmd import (
            sharded_rgcn_conv)

        return sharded_rgcn_conv(x, edges, layer, mesh, backend=backend,
                                 compute_dtype=compute_dtype)
    w = materialize_weight(layer)
    cast = (lambda t: t) if compute_dtype is None else (
        lambda t: t.to(compute_dtype))
    if aggr == "attention":
        agg = attention_aggregate(cast(x), cast(w), cast(layer.root), edges,
                                  backend=backend)
    elif aggr == "mean":
        if mode == "auto":
            mode = auto_mode(edges, w.shape[1], w.shape[2])
        agg = relational_aggregate(cast(x), cast(w), edges, mode, backend)
    else:
        raise ValueError(f"unknown aggr {aggr!r}")
    return agg + x @ layer.root + layer.bias
