"""Span kernels of the R-GCN conv: the Hopper edge plan, the two kernel
wrappers with launch counters, and their plain PyTorch versions.

The JAX package runs the conv's message passing as two Pallas kernels
(``scaling_rgcn_training_tpu/ops/span_kernels.py``: ``_fwd_kernel`` through
``rel_span_matmul_scatter``, ``_bwd_kernel`` through
``rel_span_backward_scatter``). Here they are hand-written CUDA for
``sm_90a`` on the tensor cores over the plan's relation chunks (the
forward ``csrc/span_fwd_tc.cu``, the backward ``csrc/span_bwd_tc.cu``;
their shared helpers ``csrc/span_tc.cuh``), with the same contract in node
order:

- ``span_forward(x, w, plan) -> out [N, d_out]``,
  ``out[n] = sum_{e: dst_e = n} norm_e * x[src_e] @ w[rel_e]``;
- ``span_backward(g_out, x, w, plan) -> (dx [N, d_in], dw [slots, d_in, d_out])``,
  ``dx[n] = sum_{e: src_e = n} norm_e * g_out[dst_e] @ w[rel_e]^T`` and
  ``dw[r] = sum_{e: rel_e = r} x[src_e]^T (norm_e * g_out[dst_e])``.

``x``/``w``/``g_out`` are float32 or bfloat16; every sum is float32 and the
results are float32 (float64 in, float64 out on the CPU, for gradcheck).
The row gathers ``x[src]`` and ``g_out[dst]`` happen inside the kernels.

A wrapper runs the plain version when its tensors lie on the CPU, launches
the kernel when they lie on a CUDA device, and raises otherwise. The
kernels are built with ``nvcc`` at first use into ``build/torch_kernels/``
and loaded with ``ctypes`` (``ops/cuda_build.py``); a failed build raises.

The earlier routes on the CUDA cores (``csrc/span_kernels.cu``) stay
callable as ``span_forward_rows`` and ``span_backward_rows``; no main path
calls them.

The plan (:class:`SpanPlan`) is the port's own, built in numpy from
``(src, dst, rel, norm)``: a dst-sorted CSR for the forward sum, a
src-sorted CSR for the dx sum, and relation-sorted edges cut into
one-relation chunks, over which both kernels form their per-edge products.
None of the TPU plan's machinery (relation bands, tile-packed edge
columns, swept bucket sizes, padding) is needed on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.utils import tracing
from scaling_rgcn_training_tpu_torch.utils.plantree import to_device

# edges of one relation per dW block (partial sums reduced in order)
DW_CHUNK = 1024
# widths the CUDA kernels take (csrc/span_fwd_tc.cu, csrc/span_bwd_tc.cu,
# csrc/span_kernels.cu)
MAX_WIDTH = 128
MAX_DW_ELEMS = 4096


@dataclasses.dataclass(frozen=True)
class SpanPlan:
    """Host-built edge layouts of one graph, as int32/float32 tensors.

    ``num_nodes`` (N) is the count of output rows (``dst`` range) and
    ``num_src`` that of input rows (``src`` range); they differ in the
    halo partition, whose halo segment reads a received row buffer.

    - forward, dst-sorted CSR by ``(dst, rel)``: ``fwd_rowptr [N+1]``,
      ``fwd_src``, ``fwd_rel``, ``fwd_norm`` ``[E]``, and ``fwd_pos [E]``,
      each edge's index in the relation order below;
    - dx, src-sorted CSR by ``(src, rel)``: ``bwd_rowptr [num_src+1]``,
      ``bwd_dst``, ``bwd_rel``, ``bwd_norm`` ``[E]``, and ``bwd_pos [E]``,
      each edge's index in the relation order below;
    - dW, relation-sorted by ``(rel, src)``: ``rel_src``, ``rel_dst``,
      ``rel_norm`` ``[E]``; chunks of at most ``DW_CHUNK`` edges of one
      relation ``[chunk_lo, chunk_hi)``; relation ``r`` owns chunks
      ``rel_chunk_ptr[r]:rel_chunk_ptr[r+1]`` and edges
      ``rel_edge_ptr[r]:rel_edge_ptr[r+1]`` (host ints, for the plain
      version's per-relation slices).
    """

    num_nodes: int
    num_slots: int
    num_src: int
    fwd_rowptr: torch.Tensor
    fwd_src: torch.Tensor
    fwd_rel: torch.Tensor
    fwd_norm: torch.Tensor
    fwd_pos: torch.Tensor
    bwd_rowptr: torch.Tensor
    bwd_dst: torch.Tensor
    bwd_rel: torch.Tensor
    bwd_norm: torch.Tensor
    bwd_pos: torch.Tensor
    rel_src: torch.Tensor
    rel_dst: torch.Tensor
    rel_norm: torch.Tensor
    chunk_lo: torch.Tensor
    chunk_hi: torch.Tensor
    rel_chunk_ptr: torch.Tensor
    rel_edge_ptr: Tuple[int, ...]

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_lo.shape[0])

    @property
    def device(self) -> torch.device:
        return self.fwd_src.device


def _csr(row: np.ndarray, rel: np.ndarray, num_rows: int, num_slots: int):
    """Order sorting edges by (row, rel), and the row pointer."""
    order = np.argsort(row.astype(np.int64) * num_slots + rel, kind="stable")
    counts = np.bincount(row, minlength=num_rows)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return order, rowptr


def check_edges(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                norm: np.ndarray, num_nodes: int, num_slots: int,
                num_src: Optional[int] = None):
    """Per-edge ``(src, dst, rel, norm)`` as int32/float32 arrays; raises
    for arrays of other lengths, endpoints or relations out of range
    (``dst`` in ``[0, num_nodes)``, ``src`` in ``[0, num_src)``, which
    defaults to ``num_nodes``), or more edges than the kernels' int32
    offsets hold."""
    num_src = num_nodes if num_src is None else num_src
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    rel = np.asarray(rel, np.int32)
    norm = np.asarray(norm, np.float32)
    e = src.shape[0]
    if not (dst.shape == rel.shape == norm.shape == (e,)):
        raise ValueError("src, dst, rel and norm must be 1-D of one length")
    if e >= 2**31 - 1:
        raise ValueError(f"{e} edges do not fit the kernels' int32 offsets")
    if e and (min(src.min(), dst.min()) < 0 or dst.max() >= num_nodes
              or src.max() >= num_src):
        raise ValueError("edge endpoint outside [0, num_nodes) (dst) or "
                         "[0, num_src) (src)")
    if e and (rel.min() < 0 or rel.max() >= num_slots):
        raise ValueError("relation outside [0, num_slots)")
    return src, dst, rel, norm


def relation_chunks(src: np.ndarray, rel: np.ndarray, num_src: int,
                    num_slots: int):
    """The relation order of the edges and its chunks, as numpy arrays:
    ``r_order`` sorts the edges by ``(rel, src)``, ``rel_rank`` is each
    edge's index in that order, ``rel_edge_ptr [slots + 1]`` (int64) and
    ``rel_chunk_ptr [slots + 1]`` bound each relation's edges and chunks,
    and chunk ``c`` holds edges ``[chunk_lo[c], chunk_hi[c])``, at most
    ``DW_CHUNK`` of one relation."""
    r_order = np.argsort(rel.astype(np.int64) * max(num_src, 1) + src,
                         kind="stable")
    rel_counts = np.bincount(rel, minlength=num_slots)
    rel_edge_ptr = np.concatenate([[0], np.cumsum(rel_counts)]).astype(np.int64)
    n_chunk = -(-rel_counts // DW_CHUNK)
    rel_chunk_ptr = np.concatenate([[0], np.cumsum(n_chunk)]).astype(np.int32)
    chunk_rel = np.repeat(np.arange(num_slots), n_chunk)
    within = np.arange(chunk_rel.shape[0]) - rel_chunk_ptr[chunk_rel]
    chunk_lo = rel_edge_ptr[chunk_rel] + within * DW_CHUNK
    chunk_hi = np.minimum(chunk_lo + DW_CHUNK, rel_edge_ptr[chunk_rel + 1])
    rel_rank = np.empty(r_order.shape[0], np.int64)
    rel_rank[r_order] = np.arange(r_order.shape[0])
    return r_order, rel_rank, rel_edge_ptr, rel_chunk_ptr, chunk_lo, chunk_hi


def plan_span(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
              norm: np.ndarray, num_nodes: int, num_slots: int,
              device=None, num_src: Optional[int] = None) -> SpanPlan:
    """Build the three edge layouts from per-edge ``(src, dst, rel, norm)``
    (``dst < num_nodes``, ``src < num_src``, by default ``num_nodes``), on
    the CPU; with ``device``, moved there. The two CSR sorts and the
    relation order run in the recorder's ``plan.sort`` span
    (``utils/tracing.py``)."""
    num_src = num_nodes if num_src is None else num_src
    src, dst, rel, norm = check_edges(src, dst, rel, norm, num_nodes,
                                      num_slots, num_src)

    with tracing.span("plan.sort"):
        f_order, f_rowptr = _csr(dst, rel, num_nodes, num_slots)
        b_order, b_rowptr = _csr(src, rel, num_src, num_slots)
        r_order, rel_rank, rel_edge_ptr, rel_chunk_ptr, chunk_lo, \
            chunk_hi = relation_chunks(src, rel, num_src, num_slots)

    t = lambda a, dtype=torch.int32: torch.as_tensor(
        np.ascontiguousarray(a)).to(dtype)
    plan = SpanPlan(
        num_nodes=int(num_nodes), num_slots=int(num_slots),
        num_src=int(num_src), fwd_rowptr=t(f_rowptr), fwd_src=t(src[f_order]),
        fwd_rel=t(rel[f_order]), fwd_norm=t(norm[f_order], torch.float32),
        fwd_pos=t(rel_rank[f_order]),
        bwd_rowptr=t(b_rowptr), bwd_dst=t(dst[b_order]),
        bwd_rel=t(rel[b_order]), bwd_norm=t(norm[b_order], torch.float32),
        bwd_pos=t(rel_rank[b_order]),
        rel_src=t(src[r_order]), rel_dst=t(dst[r_order]),
        rel_norm=t(norm[r_order], torch.float32),
        chunk_lo=t(chunk_lo), chunk_hi=t(chunk_hi),
        rel_chunk_ptr=t(rel_chunk_ptr),
        rel_edge_ptr=tuple(int(v) for v in rel_edge_ptr))
    return plan if device is None else to_device(plan, device)


# -- plain PyTorch versions (PyG RGCNConv's per-relation loop) ---------------

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _relation_slices(plan: SpanPlan):
    p = plan.rel_edge_ptr
    for r in range(plan.num_slots):
        if p[r + 1] > p[r]:
            yield r, slice(p[r], p[r + 1])


def span_forward_plain(x: torch.Tensor, w: torch.Tensor,
                       plan: SpanPlan) -> torch.Tensor:
    """``span_forward`` with index_select, one matmul per relation and
    index_add_, summed in ``_acc_dtype``."""
    acc = _acc_dtype(x.dtype)
    out = torch.zeros(plan.num_nodes, w.shape[2], dtype=acc, device=x.device)
    for r, sl in _relation_slices(plan):
        msg = x.index_select(0, plan.rel_src[sl]).to(acc) @ w[r].to(acc)
        out.index_add_(0, plan.rel_dst[sl],
                       msg * plan.rel_norm[sl, None].to(acc))
    return out


def span_forward_tiled_plain(x: torch.Tensor, w: torch.Tensor,
                             plan: SpanPlan) -> torch.Tensor:
    """``span_forward`` in the CUDA kernels' dataflow, for tests and
    chip_smoke.py: each chunk's messages ``norm_j * x[rel_src[j]] @ w[r]``
    into a scratch ``[E, d_out]`` in relation order, then each output row's
    sum of its edges' messages in forward-CSR order through ``fwd_pos``;
    summed in ``_acc_dtype``."""
    acc = _acc_dtype(x.dtype)
    msg = torch.zeros(plan.fwd_pos.shape[0], w.shape[2], dtype=acc,
                      device=x.device)
    ptr = plan.rel_chunk_ptr.tolist()
    lo, hi = plan.chunk_lo.tolist(), plan.chunk_hi.tolist()
    for r in range(plan.num_slots):
        for c in range(ptr[r], ptr[r + 1]):
            sl = slice(lo[c], hi[c])
            msg[sl] = (x.index_select(0, plan.rel_src[sl]).to(acc)
                       @ w[r].to(acc)) * plan.rel_norm[sl, None].to(acc)
    rows = torch.repeat_interleave(
        torch.arange(plan.num_nodes, device=x.device),
        torch.diff(plan.fwd_rowptr.long()))
    out = torch.zeros(plan.num_nodes, w.shape[2], dtype=acc, device=x.device)
    return out.index_add_(0, rows, msg.index_select(0, plan.fwd_pos))


def span_backward_plain(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                        plan: SpanPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``span_backward`` with index_select, per-relation matmuls and
    index_add_, summed in ``_acc_dtype``."""
    acc = _acc_dtype(x.dtype)
    dx = torch.zeros(plan.num_src, w.shape[1], dtype=acc, device=x.device)
    dw = torch.zeros(w.shape, dtype=acc, device=x.device)
    for r, sl in _relation_slices(plan):
        t = (g_out.index_select(0, plan.rel_dst[sl]).to(acc)
             * plan.rel_norm[sl, None].to(acc))
        dx.index_add_(0, plan.rel_src[sl], t @ w[r].to(acc).T)
        dw[r] = x.index_select(0, plan.rel_src[sl]).to(acc).T @ t
    return dx, dw


def span_backward_tiled_plain(g_out: torch.Tensor, x: torch.Tensor,
                              w: torch.Tensor, plan: SpanPlan
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``span_backward`` in the CUDA kernels' dataflow, for tests and
    chip_smoke.py: per chunk, the gathered ``g_out`` rows times ``norm``,
    rounded to the input type (``t``), then the dx messages ``t @ w[r]^T``
    into a scratch ``[E, d_in]`` in relation order and the chunk's dW
    partial ``x[rel_src]^T t``; then each src row's sum of its edges'
    messages in src-CSR order through ``bwd_pos`` and each relation's sum
    of its partials in chunk order; summed in ``_acc_dtype``."""
    acc = _acc_dtype(x.dtype)
    slots, d_in, d_out = w.shape
    msg = torch.zeros(plan.bwd_pos.shape[0], d_in, dtype=acc, device=x.device)
    dw = torch.zeros(w.shape, dtype=acc, device=x.device)
    ptr = plan.rel_chunk_ptr.tolist()
    lo, hi = plan.chunk_lo.tolist(), plan.chunk_hi.tolist()
    for r in range(slots):
        for c in range(ptr[r], ptr[r + 1]):
            sl = slice(lo[c], hi[c])
            t = (g_out.index_select(0, plan.rel_dst[sl]).to(acc)
                 * plan.rel_norm[sl, None].to(acc)).to(g_out.dtype).to(acc)
            msg[sl] = t @ w[r].to(acc).T
            dw[r] += x.index_select(0, plan.rel_src[sl]).to(acc).T @ t
    rows = torch.repeat_interleave(
        torch.arange(plan.num_src, device=x.device),
        torch.diff(plan.bwd_rowptr.long()))
    dx = torch.zeros(plan.num_src, d_in, dtype=acc, device=x.device)
    return dx.index_add_(0, rows, msg.index_select(0, plan.bwd_pos)), dw


# -- the CUDA kernels --------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.span_rows.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.span_rows.restype = i
    lib.span_dw.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.span_dw.restype = i


def _kernels() -> ctypes.CDLL:
    return cuda_build.load("span_kernels", _declare)


def _declare_tc(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.span_fwd_tc.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i,
                                i, i, p]
    lib.span_fwd_tc.restype = i


def _tc_kernels() -> ctypes.CDLL:
    return cuda_build.load("span_fwd_tc", _declare_tc)


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.span_bwd_tc.argtypes = [i, i, *[p] * 15, i, i, i, i, i, p]
    lib.span_bwd_tc.restype = i


def _bwd_kernels() -> ctypes.CDLL:
    return cuda_build.load("span_bwd_tc", _declare_bwd)


def _cuda_dtype_code(*tensors: torch.Tensor) -> int:
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"span kernels take float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("span kernels take contiguous tensors")
    return 1 if dtype == torch.bfloat16 else 0


def _check_shapes(x: torch.Tensor, w: torch.Tensor, plan: SpanPlan) -> None:
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "match [N, d_in] and [slots, d_in, d_out]")
    if x.shape[0] != plan.num_src or w.shape[0] != plan.num_slots:
        raise ValueError(f"plan has {plan.num_src} source rows and "
                         f"{plan.num_slots} slots, got x {tuple(x.shape)} "
                         f"and w {tuple(w.shape)}")


def fused_ok(d_in: int, d_out: int) -> bool:
    """Whether the span kernels take a layer of these widths."""
    return d_in <= MAX_WIDTH and d_out <= MAX_WIDTH and d_in * d_out <= MAX_DW_ELEMS


def _check_widths(d_in: int, d_out: int) -> None:
    if not fused_ok(d_in, d_out):
        raise ValueError(f"span kernels take d_in, d_out <= {MAX_WIDTH} and "
                         f"d_in * d_out <= {MAX_DW_ELEMS}, got {d_in}, {d_out}")


def _rows(lib, code, feat, wk, rowptr, idx, rel, norm, out, stream, what):
    err = lib.span_rows(code, feat.data_ptr(), wk.data_ptr(),
                        rowptr.data_ptr(), idx.data_ptr(), rel.data_ptr(),
                        norm.data_ptr(), out.data_ptr(), out.shape[0],
                        feat.shape[1], out.shape[1], wk.shape[0], stream)
    cuda_build.check_launch(lib, err, what)


def span_forward(x: torch.Tensor, w: torch.Tensor,
                 plan: SpanPlan) -> torch.Tensor:
    """``out[n] = sum_{e: dst_e = n} norm_e * x[src_e] @ w[rel_e]``:
    ``x [num_src, d_in]``, ``w [slots, d_in, d_out]`` -> ``[N, d_out]``
    float32. On the card two kernels of ``csrc/span_fwd_tc.cu``: the
    per-edge messages on the tensor cores, chunk by chunk, into an
    ``[E, d_out]`` float32 scratch, then their sum per row."""
    _check_shapes(x, w, plan)
    if not cuda_build.on_card(x, w, plan.fwd_src):
        return span_forward_plain(x, w, plan)
    code = _cuda_dtype_code(x, w)
    slots, d_in, d_out = w.shape
    _check_widths(d_in, d_out)
    lib = _tc_kernels()
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty(plan.num_nodes, d_out, **f32)
    msg = torch.empty(plan.fwd_pos.shape[0], d_out, **f32)
    with torch.cuda.device(x.device):
        err = lib.span_fwd_tc(
            code, x.data_ptr(), w.data_ptr(), plan.chunk_lo.data_ptr(),
            plan.chunk_hi.data_ptr(), plan.rel_chunk_ptr.data_ptr(),
            plan.rel_src.data_ptr(), plan.rel_norm.data_ptr(),
            plan.fwd_rowptr.data_ptr(), plan.fwd_pos.data_ptr(),
            msg.data_ptr(), out.data_ptr(), plan.num_chunks, plan.num_nodes,
            d_in, d_out, slots, torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, "span_forward")
    LAUNCHES["span_forward"] += 1
    return out


def forward_cost(x: torch.Tensor, w: torch.Tensor,
                 plan: SpanPlan) -> Tuple[int, int, str]:
    """``(bytes, operations, unit)`` of ``span_forward``'s function on
    these inputs, for its bound: bytes are ``x``, ``w``, the plan arrays
    its kernels read (the relation-ordered edges, the chunks, the forward
    CSR's row pointer and positions), each once, and the float32 ``out``
    once. Operations: ``2 E d_in d_out`` on the tensor cores, three times
    for float32 (3xTF32, ``unit`` ``"tf32"``), once for bfloat16. The
    ``msg`` round trip and the kernel's fourth TF32 product (``a_small
    b_small``) are the design's own cost, not the function's."""
    d_out = w.shape[2]
    n_bytes = sum(t.numel() * t.element_size() for t in (
        x, w, plan.rel_src, plan.rel_norm, plan.chunk_lo, plan.chunk_hi,
        plan.rel_chunk_ptr, plan.fwd_rowptr, plan.fwd_pos))
    n_bytes += 4 * plan.num_nodes * d_out
    ops = 2 * plan.fwd_pos.numel() * x.shape[1] * d_out
    if x.dtype == torch.bfloat16:
        return n_bytes, ops, "bfloat16"
    return n_bytes, 3 * ops, "tf32"


def backward_cost(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  plan: SpanPlan) -> Tuple[int, int, str]:
    """``(bytes, operations, unit)`` of ``span_backward``'s function on
    these inputs, for its bound: bytes are ``g_out``, ``x``, ``w``, the
    plan arrays its kernels read (the relation-ordered edges, the chunks,
    the src-sorted CSR's row pointer and positions), each once, and the
    float32 ``dx`` and ``dw`` once. Operations: ``2 E d_in d_out`` for each
    half on the tensor cores, three times for float32 (3xTF32, ``unit``
    ``"tf32"``), once for bfloat16. The ``[E, d_in]`` message round trip
    and the kernel's fourth TF32 product are the design's own cost, not the
    function's."""
    slots, d_in, d_out = w.shape
    n_bytes = sum(t.numel() * t.element_size() for t in (
        g_out, x, w, plan.rel_src, plan.rel_dst, plan.rel_norm, plan.chunk_lo,
        plan.chunk_hi, plan.rel_chunk_ptr, plan.bwd_rowptr, plan.bwd_pos))
    n_bytes += 4 * (plan.num_src * d_in + slots * d_in * d_out)
    ops = 2 * 2 * plan.bwd_pos.numel() * d_in * d_out
    if x.dtype == torch.bfloat16:
        return n_bytes, ops, "bfloat16"
    return n_bytes, 3 * ops, "tf32"


def span_forward_rows(x: torch.Tensor, w: torch.Tensor,
                      plan: SpanPlan) -> torch.Tensor:
    """``span_forward`` by the earlier route, ``span_rows_kernel``
    (``csrc/span_rows.cuh``: one warp per dst row, scalar FMAs on the
    CUDA cores). No main path calls it: chip_smoke.py times it beside
    ``span_forward``, and the microbench's ``fwdrev`` row measures the
    earlier backward route's dx half with it."""
    _check_shapes(x, w, plan)
    if not cuda_build.on_card(x, w, plan.fwd_src):
        return span_forward_plain(x, w, plan)
    code = _cuda_dtype_code(x, w)
    _check_widths(x.shape[1], w.shape[2])
    lib = _kernels()
    out = torch.empty(plan.num_nodes, w.shape[2], dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _rows(lib, code, x, w, plan.fwd_rowptr, plan.fwd_src, plan.fwd_rel,
              plan.fwd_norm, out, stream, "span_forward_rows")
    LAUNCHES["span_forward_rows"] += 1
    return out


def _check_backward(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    plan: SpanPlan) -> bool:
    """Check a backward call's shapes; True when its tensors lie on the
    card (then also their types and widths), False on the CPU."""
    _check_shapes(x, w, plan)
    if g_out.shape != (plan.num_nodes, w.shape[2]):
        raise ValueError(f"g_out {tuple(g_out.shape)} is not "
                         f"[{plan.num_nodes}, {w.shape[2]}]")
    if not cuda_build.on_card(g_out, x, w, plan.fwd_src):
        return False
    _check_widths(w.shape[1], w.shape[2])
    return True


def _backward_tc(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                 plan: SpanPlan, parts: int
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The kernels of ``csrc/span_bwd_tc.cu`` on the card: ``parts`` 1 the
    dx half, 2 the dW half, 3 both (the chunk kernel, then the dx sum and
    the dW reduce)."""
    code = _cuda_dtype_code(g_out, x, w)
    slots, d_in, d_out = w.shape
    lib = _bwd_kernels()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = msg = dw = partial = None
    if parts & 1:
        dx = torch.empty(plan.num_src, d_in, **f32)
        msg = torch.empty(plan.bwd_pos.shape[0], d_in, **f32)
    if parts & 2:
        dw = torch.empty(slots, d_in, d_out, **f32)
        partial = torch.empty(plan.num_chunks, d_in, d_out, **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.span_bwd_tc(
            code, parts, g_out.data_ptr(), x.data_ptr(), w.data_ptr(),
            plan.chunk_lo.data_ptr(), plan.chunk_hi.data_ptr(),
            plan.rel_chunk_ptr.data_ptr(), plan.rel_src.data_ptr(),
            plan.rel_dst.data_ptr(), plan.rel_norm.data_ptr(),
            plan.bwd_rowptr.data_ptr(), plan.bwd_pos.data_ptr(), ptr(msg),
            ptr(partial), ptr(dx), ptr(dw), plan.num_chunks, plan.num_src,
            d_in, d_out, slots, torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, "span_backward")
    return dx, dw


def span_backward(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  plan: SpanPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both aggregation gradients: ``g_out [N, d_out]`` (in ``w``'s dtype)
    -> ``dx [num_src, d_in]`` and ``dw [slots, d_in, d_out]``, float32. On
    the card three kernels of ``csrc/span_bwd_tc.cu``: per relation chunk,
    the dx messages into an ``[E, d_in]`` float32 scratch and the dW
    partials, both on the tensor cores, then the messages' sum per src row
    and the partials' sum per relation."""
    if not _check_backward(g_out, x, w, plan):
        return span_backward_plain(g_out, x, w, plan)
    dx, dw = _backward_tc(g_out, x, w, plan, 3)
    LAUNCHES["span_backward"] += 1
    return dx, dw


def span_backward_half(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                       plan: SpanPlan, half: str) -> torch.Tensor:
    """One half of ``span_backward`` alone, ``half`` ``"dx"`` (the chunk
    kernel's dx messages and their sum per src row) or ``"dw"`` (its dW
    partials and their sum per relation), for timing each half: no main
    path calls it."""
    if half not in ("dx", "dw"):
        raise ValueError(f"half {half!r} is not 'dx' or 'dw'")
    which = ("dx", "dw").index(half)
    if not _check_backward(g_out, x, w, plan):
        return span_backward_plain(g_out, x, w, plan)[which]
    out = _backward_tc(g_out, x, w, plan, 1 << which)[which]
    LAUNCHES["span_backward_half"] += 1
    return out


def span_backward_rows(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                       plan: SpanPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``span_backward`` by the earlier route on the CUDA cores
    (``csrc/span_kernels.cu``): dx by ``span_rows_kernel`` over the
    src-sorted CSR with ``W^T``, dW by ``span_dw_partial_kernel``'s scalar
    FMAs per chunk and the chunk-ordered reduce. No main path calls it:
    chip_smoke.py times it beside ``span_backward``, and so does the
    microbench's ``rows`` row."""
    if not _check_backward(g_out, x, w, plan):
        return span_backward_plain(g_out, x, w, plan)
    code = _cuda_dtype_code(g_out, x, w)
    slots, d_in, d_out = w.shape
    lib = _kernels()
    dev = x.device
    dx = torch.empty(plan.num_src, d_in, dtype=torch.float32, device=dev)
    dw = torch.empty(slots, d_in, d_out, dtype=torch.float32, device=dev)
    partial = torch.empty(max(plan.num_chunks, 1), d_in, d_out,
                          dtype=torch.float32, device=dev)
    wt = w.transpose(1, 2).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _rows(lib, code, g_out, wt, plan.bwd_rowptr, plan.bwd_dst,
              plan.bwd_rel, plan.bwd_norm, dx, stream,
              "span_backward_rows (dx)")
        err = lib.span_dw(code, x.data_ptr(), g_out.data_ptr(),
                          plan.chunk_lo.data_ptr(), plan.chunk_hi.data_ptr(),
                          plan.rel_chunk_ptr.data_ptr(),
                          plan.rel_src.data_ptr(), plan.rel_dst.data_ptr(),
                          plan.rel_norm.data_ptr(), partial.data_ptr(),
                          dw.data_ptr(), plan.num_chunks, slots, d_in, d_out,
                          stream)
        cuda_build.check_launch(lib, err, "span_backward_rows (dW)")
    LAUNCHES["span_backward_rows"] += 1
    return dx, dw
