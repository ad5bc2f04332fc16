"""Kernel #7: the halo exchange fused with the shard's relational
aggregation, and its autograd.

For receiving shard ``me`` of an S-shard halo partition:

    agg[n] = sum_{e: dst_e = n} norm_e * row(src_e) @ W[rel_e]

over all of the shard's edges, local and halo, where ``src_e`` is the
edge's global (partition-padded) node id and ``row(i)`` is row
``i % n_per`` of shard ``i // n_per``: the shard's own ``x_own``, or the
peer's row ``send_idx[p, me, pos]`` read straight from the peer's memory.
So the halo gather and the exchange both happen inside the kernel. The
kernel also writes the received halo buffer ``buf [S * H, d]``,
``buf[p * H + j] = x_own_p[recv_idx[p, j]]`` (what the library exchange
would deliver), which the backward reads.

:func:`fused_halo_aggregate` replaces the TPU kernel
``scaling_rgcn_training_tpu/parallel/fused_halo.py:307`` ``_fused_kernel``
with ``fused_halo_tc`` (``csrc/halo_kernels.cu``): #1's chunk kernel
``span_msg_kernel`` over a row source of the S shards' rows (per relation
chunk, the messages on the tensor cores into an ``[E, d_out]`` float32
scratch), ``span_msg_sum_kernel`` (each dst row's messages in forward-CSR
order) and, with the buffer, ``halo_buf_kernel``. On the CPU it runs
:func:`fused_halo_aggregate_plain`. The plan (:class:`FusedHaloPlan`) is
built in numpy with no padding: the dst-sorted CSR and #1's relation
chunks over the global src ids (``span_kernels.relation_chunks``); none of
the TPU plan's tile packing, chunk padding, per-edge Python planner or
blow-up gate is needed. :func:`fused_halo_aggregate_rows` keeps the
earlier route (the CUDA-core row kernel over the shards' rows), and
:func:`fused_halo_aggregate_tiled_plain` is the kernel's dataflow in
PyTorch; no main path calls either.

:class:`FusedHaloApply` follows the JAX package's ``_fused_apply_bwd``:
the span backward (#2) over each shard's local and halo plans, then the
reverse exchange of the halo cotangents (the library exchange) and the
transpose of the send gather.

Across processes (:func:`fused_halo_shards` on a mesh of several) each
process runs #7 for its k shards: a layer call copies its ``x_own`` rows
once into its CUDA IPC buffer (``parallel/ipc.py``), and the kernels read
the other processes' shards through their buffers, mapped here
(:func:`fused_halo_cost` counts that copy with ``copied=True``); the
backward's exchange crosses the processes too. On the CPU the plain
version across processes is the library exchange between processes (the
halo buffer) plus the aggregation of the local and halo segments: the
same function.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.ops.span_kernels import (
    _acc_dtype, _csr, _cuda_dtype_code, _check_widths, check_edges,
    relation_chunks, span_backward, span_forward, span_forward_tiled_plain)
from scaling_rgcn_training_tpu_torch.parallel.ipc import peer_set
from scaling_rgcn_training_tpu_torch.parallel.mesh import CROSS_CARD, Mesh
from scaling_rgcn_training_tpu_torch.parallel.ring_halo import (
    connect, exchange_across, halo_exchange_library, halo_kernels, on_cards,
    pointer_table, release_sources, send_transpose, wait_for_sources)


@dataclasses.dataclass(frozen=True)
class FusedHaloPlan:
    """Shard ``shard``'s plan for kernel #7, int32/float32 tensors on its
    device, over all its edges with ``src`` the global node id:

    - the CSR by ``(dst, rel)``: ``rowptr [n_per + 1]``, ``src``, ``rel``,
      ``norm`` (the earlier route's and the plain version's), and
      ``fwd_pos``, each CSR edge's index in the relation order below;
    - #1's layout: the edges by ``(rel, src)``, ``rel_src``, ``rel_norm``,
      cut into chunks ``[chunk_lo, chunk_hi)`` of at most ``DW_CHUNK``
      edges of one relation, relation ``r`` owning chunks
      ``rel_chunk_ptr[r]:rel_chunk_ptr[r+1]``;
    - ``recv_idx [S * H]``, the rows each peer ships to it (peer-major:
      the JAX plan's ``send_idx[p, shard]``).

    ``num_nodes`` and ``fwd_rowptr`` name ``n_per`` and ``rowptr`` as a
    :class:`~scaling_rgcn_training_tpu_torch.ops.span_kernels.SpanPlan`
    does, so ``span_forward_tiled_plain`` reads the plan as it is."""

    shard: int
    num_shards: int
    n_per: int
    halo: int
    num_slots: int
    rowptr: torch.Tensor
    src: torch.Tensor
    rel: torch.Tensor
    norm: torch.Tensor
    fwd_pos: torch.Tensor
    rel_src: torch.Tensor
    rel_norm: torch.Tensor
    chunk_lo: torch.Tensor
    chunk_hi: torch.Tensor
    rel_chunk_ptr: torch.Tensor
    recv_idx: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.n_per

    @property
    def fwd_rowptr(self) -> torch.Tensor:
        return self.rowptr

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_lo.shape[0])


def plan_fused_halo(shard: int, src: np.ndarray, dst: np.ndarray,
                    rel: np.ndarray, norm: np.ndarray, recv_idx: np.ndarray,
                    n_per: int, halo: int, num_shards: int,
                    num_slots: int) -> FusedHaloPlan:
    """From the shard's edges: global ``src`` (``< num_shards * n_per``),
    owner-local ``dst``; built on the CPU."""
    num_src = num_shards * n_per
    src, dst, rel, norm = check_edges(src, dst, rel, norm, n_per, num_slots,
                                      num_src)
    order, rowptr = _csr(dst, rel, n_per, num_slots)
    r_order, rel_rank, _, rel_chunk_ptr, chunk_lo, chunk_hi = \
        relation_chunks(src, rel, num_src, num_slots)
    t = lambda a, dtype=torch.int32: torch.as_tensor(
        np.ascontiguousarray(a)).to(dtype)
    return FusedHaloPlan(
        shard=int(shard), num_shards=int(num_shards), n_per=int(n_per),
        halo=int(halo), num_slots=int(num_slots), rowptr=t(rowptr),
        src=t(src[order]), rel=t(rel[order]),
        norm=t(norm[order], torch.float32), fwd_pos=t(rel_rank[order]),
        rel_src=t(src[r_order]), rel_norm=t(norm[r_order], torch.float32),
        chunk_lo=t(chunk_lo), chunk_hi=t(chunk_hi),
        rel_chunk_ptr=t(rel_chunk_ptr),
        recv_idx=t(np.asarray(recv_idx).reshape(-1)))


def _check(x_owns: Sequence[torch.Tensor], w: torch.Tensor,
           plan: FusedHaloPlan) -> None:
    if len(x_owns) != plan.num_shards:
        raise ValueError(f"plan has {plan.num_shards} shards, got "
                         f"{len(x_owns)} x_own")
    for x in x_owns:
        if x.shape != (plan.n_per, w.shape[1]) or x.dtype != w.dtype:
            raise ValueError(f"x_own must be [{plan.n_per}, {w.shape[1]}] "
                             f"{w.dtype}, got {tuple(x.shape)} {x.dtype}")
    if w.dim() != 3 or w.shape[0] != plan.num_slots:
        raise ValueError(f"w {tuple(w.shape)} is not [{plan.num_slots}, "
                         "d_in, d_out]")


def _halo_buffer_plain(x_owns: Sequence[torch.Tensor], plan: FusedHaloPlan,
                       device) -> torch.Tensor:
    """``buf[p * H + j] = x_owns[p][recv_idx[p * H + j]]``: this
    receiver's blocks of the plain exchange."""
    h = plan.halo
    return torch.cat([x.index_select(0, plan.recv_idx[p * h:(p + 1) * h]
                                     .to(x.device)).to(device)
                      for p, x in enumerate(x_owns)])


def fused_halo_aggregate_plain(x_owns: Sequence[torch.Tensor],
                               w: torch.Tensor, plan: FusedHaloPlan,
                               want_buf: bool = True
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel #7's plain version: the combined rows of all shards
    (``torch.cat``, then ``index_select`` of each edge's row), one matmul
    per relation and ``index_add_``, summed in ``_acc_dtype``; the halo
    buffer from the plain exchange's blocks."""
    dev = w.device
    acc = _acc_dtype(w.dtype)
    rows = torch.cat([x.to(dev) for x in x_owns])
    dst = torch.repeat_interleave(
        torch.arange(plan.n_per, device=dev), plan.rowptr.diff())
    out = torch.zeros(plan.n_per, w.shape[2], dtype=acc, device=dev)
    for r in range(plan.num_slots):
        m = plan.rel == r
        if bool(m.any()):
            msg = rows.index_select(0, plan.src[m]).to(acc) @ w[r].to(acc)
            out.index_add_(0, dst[m], msg * plan.norm[m, None].to(acc))
    buf = _halo_buffer_plain(x_owns, plan, dev) if want_buf else None
    return out, buf


def fused_halo_aggregate_tiled_plain(
        x_owns: Sequence[torch.Tensor], w: torch.Tensor, plan: FusedHaloPlan,
        want_buf: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel #7 in its CUDA dataflow, for tests and chip_smoke.py: each
    chunk's messages in relation order, then each dst row's sum through
    ``fwd_pos`` (``span_forward_tiled_plain`` over the combined rows), and
    the halo buffer as the plain version gives it."""
    dev = w.device
    out = span_forward_tiled_plain(torch.cat([x.to(dev) for x in x_owns]),
                                   w, plan)
    buf = _halo_buffer_plain(x_owns, plan, dev) if want_buf else None
    return out, buf


def _on_card(x_owns: Sequence[torch.Tensor], w: torch.Tensor,
             plan: FusedHaloPlan, want_buf: bool, name: str, launch
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One call of a route of #7 for shard ``plan.shard``: the plain
    version when the tensors lie on the CPU; on the card, after checking
    the types, widths and this shard's device, ``launch(lib, out, buf,
    stream)`` with ``out [n_per, d_out]`` float32 and ``buf`` (or None)
    allocated, this shard's stream ordered after and before the other
    cards' streams, and its error checked; counts one launch of ``name``."""
    _check(x_owns, w, plan)
    if not on_cards([*x_owns, w, plan.src]):
        return fused_halo_aggregate_plain(x_owns, w, plan, want_buf)
    _cuda_dtype_code(*x_owns, w)
    _check_widths(w.shape[1], w.shape[2])
    dev = w.device
    if plan.src.device != dev or x_owns[plan.shard].device != dev:
        raise ValueError(f"shard {plan.shard}'s x_own, w and plan must lie on "
                         "one device")
    lib = halo_kernels()
    connect(lib, dev, x_owns)
    out = torch.empty(plan.n_per, w.shape[2], dtype=torch.float32, device=dev)
    buf = torch.empty(plan.num_shards * plan.halo, w.shape[1], dtype=w.dtype,
                      device=dev) if want_buf else None
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        wait_for_sources(stream, x_owns)
        err = launch(lib, out, buf, stream.cuda_stream)
        cuda_build.check_launch(lib, err, name)
        release_sources(stream, x_owns)
    # the halo rows it reads from another card, counted once each (the
    # rows of the halo buffer; a row read by several edges is read again)
    CROSS_CARD["bytes"] += plan.halo * w.shape[1] * w.element_size() * sum(
        x.device != dev for x in x_owns)
    LAUNCHES[name] += 1
    return out, buf


def fused_halo_aggregate(x_owns: Sequence[torch.Tensor], w: torch.Tensor,
                         plan: FusedHaloPlan, want_buf: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel #7 for shard ``plan.shard``: ``x_owns[p] [n_per, d_in]`` on
    shard ``p``'s device, ``w [slots, d_in, d_out]`` on this shard's ->
    ``agg [n_per, d_out]`` float32 and, with ``want_buf``, the halo buffer
    ``[S * H, d_in]`` in ``w``'s dtype (else None). On the card the three
    kernels of ``fused_halo_tc`` (``csrc/halo_kernels.cu``), with an
    ``[E, d_out]`` float32 scratch of messages."""
    slots, d_in, d_out = w.shape

    def launch(lib, out, buf, stream):
        msg = torch.empty(plan.fwd_pos.shape[0], d_out, dtype=torch.float32,
                          device=out.device)
        return lib.fused_halo_tc(
            _cuda_dtype_code(w), pointer_table(x_owns), plan.num_shards,
            plan.n_per, w.data_ptr(), plan.chunk_lo.data_ptr(),
            plan.chunk_hi.data_ptr(), plan.rel_chunk_ptr.data_ptr(),
            plan.rel_src.data_ptr(), plan.rel_norm.data_ptr(),
            plan.rowptr.data_ptr(), plan.fwd_pos.data_ptr(), msg.data_ptr(),
            out.data_ptr(), plan.num_chunks, plan.n_per, d_in, d_out, slots,
            plan.recv_idx.data_ptr(),
            None if buf is None else buf.data_ptr(), plan.halo, stream)

    return _on_card(x_owns, w, plan, want_buf, "fused_halo_aggregate", launch)


def fused_halo_aggregate_rows(x_owns: Sequence[torch.Tensor],
                              w: torch.Tensor, plan: FusedHaloPlan,
                              want_buf: bool = True
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`fused_halo_aggregate` by the earlier route, ``fused_halo_rows``
    (``csrc/span_rows.cuh``'s row kernel over the shards' rows: one warp
    per dst row, scalar FMAs on the CUDA cores, the buffer in its
    epilogue). No main path calls it: chip_smoke.py times it beside #7."""
    slots, d_in, d_out = w.shape

    def launch(lib, out, buf, stream):
        return lib.fused_halo_rows(
            _cuda_dtype_code(w), pointer_table(x_owns), plan.num_shards,
            plan.n_per, w.data_ptr(), plan.rowptr.data_ptr(),
            plan.src.data_ptr(), plan.rel.data_ptr(), plan.norm.data_ptr(),
            out.data_ptr(), plan.n_per, d_in, d_out, slots,
            plan.recv_idx.data_ptr(),
            None if buf is None else buf.data_ptr(), plan.halo, stream)

    return _on_card(x_owns, w, plan, want_buf, "fused_halo_aggregate_rows",
                    launch)


def fused_halo_cost(x_owns: Sequence[torch.Tensor], w: torch.Tensor,
                    plan: FusedHaloPlan, want_buf: bool = True,
                    copied: bool = False) -> Tuple[int, int, str]:
    """``(bytes, operations, unit)`` of :func:`fused_halo_aggregate`'s
    function on these inputs, for its bound: bytes are every shard's
    ``x_own``, ``w`` and the plan arrays its kernels read (the
    relation-ordered edges, the chunks, the forward CSR's row pointer and
    positions, and with the buffer ``recv_idx``), each once, the float32
    ``agg`` once and the halo buffer written once; with ``copied`` (across
    processes) also this shard's ``x_own`` read and written once more, its
    copy into the process's IPC buffer. Operations: ``2 E d_in d_out`` on
    the tensor cores, three times for float32 (3xTF32, ``unit``
    ``"tf32"``), once for bfloat16. The ``msg`` round trip and the fourth
    TF32 product are the design's own cost, not the function's."""
    slots, d_in, d_out = w.shape
    plans = [plan.rel_src, plan.rel_norm, plan.chunk_lo, plan.chunk_hi,
             plan.rel_chunk_ptr, plan.rowptr, plan.fwd_pos]
    if want_buf:
        plans.append(plan.recv_idx)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (*x_owns, w, *plans))
    n_bytes += 4 * plan.n_per * d_out
    if copied:
        n_bytes += 2 * plan.n_per * d_in * w.element_size()
    if want_buf:
        n_bytes += plan.num_shards * plan.halo * d_in * w.element_size()
    ops = 2 * plan.fwd_pos.numel() * d_in * d_out
    if w.dtype == torch.bfloat16:
        return n_bytes, ops, "bfloat16"
    return n_bytes, 3 * ops, "tf32"


def fused_halo_shards(x_owns: Sequence[torch.Tensor],
                      ws: Sequence[torch.Tensor], shards,
                      mesh: Optional[Mesh] = None, want_buf: bool = True
                      ) -> Tuple[List[torch.Tensor], List]:
    """Kernel #7 for the shards of this process (``shards``, the
    partition's ``HaloShard`` plans, with their ``x_owns`` and ``ws``; every
    shard in one process): ``(aggs, bufs)``. Across processes on the card
    the other processes' rows are read through CUDA IPC; on the CPU the
    halo buffers come from the library exchange between processes and the
    aggregation from the local and halo segments' span plans."""
    if mesh is None or not mesh.multiprocess:
        sources, peers = x_owns, None
    elif on_cards(x_owns):
        peers = peer_set(halo_kernels(), mesh, x_owns[0].shape,
                         x_owns[0].dtype)
        sources = peers.publish(x_owns)
    else:
        s_n, h = mesh.size, shards[0].fused.halo
        bufs = [r.reshape(s_n * h, -1) for r in exchange_across(
            [x.index_select(0, sh.send_idx).view(s_n, h, -1)
             for x, sh in zip(x_owns, shards)], mesh)]
        aggs = [span_forward(x, w, sh.local.span)
                + span_forward(buf, w, sh.halo.span)
                for x, w, buf, sh in zip(x_owns, ws, bufs, shards)]
        return aggs, bufs if want_buf else [None] * len(aggs)
    out = [fused_halo_aggregate(sources, w, sh.fused, want_buf)
           for w, sh in zip(ws, shards)]
    if peers is not None:
        peers.release()
    return [a for a, _ in out], [b for _, b in out]


class FusedHaloApply(torch.autograd.Function):
    """This process's shards' aggregations by kernel #7: ``(shards,
    want_buf, mesh, *x_owns, *ws)`` -> the k aggregations ``[n_per, d_out]``
    float32; ``shards`` are the partition's per-shard plans of this process
    (``parallel/halo.py`` ``HaloShard``); ``mesh``: None in one process;
    ``want_buf``: a backward will run, so keep the halo buffers."""

    @staticmethod
    def forward(ctx, shards, want_buf, mesh, *tensors):
        k = len(shards)
        x_owns, ws = tensors[:k], tensors[k:]
        aggs, bufs = fused_halo_shards(x_owns, ws, shards, mesh, want_buf)
        if want_buf:
            ctx.save_for_backward(*x_owns, *ws)
            # the halo buffers are this function's own intermediates: kept
            # on ctx, so the backward can drop each once its shard is done.
            # That gives up autograd's version check, which needs none here:
            # each buffer is a fresh allocation that nothing else aliases
            # or writes (fused_halo_aggregate, exchange_across)
            ctx.bufs = list(bufs)
        ctx.shards, ctx.mesh = shards, mesh
        return tuple(aggs)

    @staticmethod
    def backward(ctx, *grads):
        shards = ctx.shards
        k = len(shards)
        saved = ctx.saved_tensors
        x_owns, ws, bufs = saved[:k], saved[k:], ctx.bufs
        if any(b is None for b in bufs):
            raise RuntimeError("kernel #7's backward runs once a forward: "
                               "an earlier backward of it freed the halo "
                               "buffers (if that one raised, its error is "
                               "the cause)")
        halo = shards[0].fused.halo
        s_n = shards[0].fused.num_shards
        dxs, dws, dbufs = [], [], []
        for q, sh in enumerate(shards):
            g = grads[q].to(ws[q].dtype).contiguous()
            dx, dw = span_backward(g, x_owns[q], ws[q], sh.local.span)
            dbuf, dw_halo = span_backward(g, bufs[q], ws[q], sh.halo.span)
            # freed here, not when the backward returns: held through the
            # reverse exchange, the k buffers (k S H d_in elements) were
            # the #7 step's peak above the library exchange's
            bufs[q] = None
            dxs.append(dx)
            dws.append((dw + dw_halo).to(ws[q].dtype))
            dbufs.append(dbuf.to(x_owns[q].dtype).view(s_n, halo, -1))
        # reverse exchange of the halo cotangents, then the send gather's
        # transpose: the rows each shard shipped get their cotangents back
        dsends = halo_exchange_library(dbufs, ctx.mesh)
        del dbufs
        for p, sh in enumerate(shards):
            dxs[p] = dxs[p] + send_transpose(
                dsends[p].reshape(s_n * halo, -1), sh).to(dxs[p].dtype)
        return (None, None, None,
                *[d.to(x.dtype) for d, x in zip(dxs, x_owns)], *dws)


def fused_halo_apply(x_owns: Sequence[torch.Tensor],
                     ws: Sequence[torch.Tensor], shards,
                     mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Differentiable kernel #7 over this process's shards of the
    partition (every shard in one process): ``x_owns[j]`` and ``ws[j]`` on
    shard ``j``'s device -> its aggregation ``[n_per, d_out]`` float32
    there, one per shard, nothing gathered onto one device."""
    want_buf = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*x_owns, *ws))
    return list(FusedHaloApply.apply(tuple(shards), want_buf, mesh, *x_owns,
                                     *ws))
