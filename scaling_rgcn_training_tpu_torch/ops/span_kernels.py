"""Span kernels of the R-GCN conv: the Hopper edge plan, the two kernel
wrappers with launch counters, and their plain PyTorch versions.

The JAX package runs the conv's message passing as two Pallas kernels
(``scaling_rgcn_training_tpu/ops/span_kernels.py``: ``_fwd_kernel`` through
``rel_span_matmul_scatter``, ``_bwd_kernel`` through
``rel_span_backward_scatter``). Here they are hand-written CUDA for
``sm_90a`` (``csrc/span_kernels.cu``), with the same contract in node
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
and loaded with ``ctypes``; a failed build raises.

The plan (:class:`SpanPlan`) is the port's own, built in numpy from
``(src, dst, rel, norm)``: a dst-sorted CSR for the forward, a src-sorted
CSR for dx, and relation-sorted edges cut into one-relation chunks for dW.
None of the TPU plan's machinery (relation bands, tile-packed edge
columns, swept bucket sizes, padding) is needed on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

# edges of one relation per dW block (partial sums reduced in order)
DW_CHUNK = 1024
# widths the CUDA kernels take (csrc/span_kernels.cu)
MAX_WIDTH = 128
MAX_DW_ELEMS = 4096

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "span_kernels.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches made by each wrapper in this process (a launch of the
# CUDA kernel adds one; the plain CPU version adds nothing)
LAUNCHES = {"span_forward": 0, "span_backward": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class SpanPlan:
    """Host-built edge layouts of one graph, as int32/float32 tensors.

    - forward, dst-sorted CSR by ``(dst, rel)``: ``fwd_rowptr [N+1]``,
      ``fwd_src``, ``fwd_rel``, ``fwd_norm`` ``[E]``;
    - dx, src-sorted CSR by ``(src, rel)``: ``bwd_rowptr [N+1]``,
      ``bwd_dst``, ``bwd_rel``, ``bwd_norm`` ``[E]``;
    - dW, relation-sorted by ``(rel, src)``: ``rel_src``, ``rel_dst``,
      ``rel_norm`` ``[E]``; chunks of at most ``DW_CHUNK`` edges of one
      relation ``[chunk_lo, chunk_hi)``; relation ``r`` owns chunks
      ``rel_chunk_ptr[r]:rel_chunk_ptr[r+1]`` and edges
      ``rel_edge_ptr[r]:rel_edge_ptr[r+1]`` (host ints, for the plain
      version's per-relation slices).
    """

    num_nodes: int
    num_slots: int
    fwd_rowptr: torch.Tensor
    fwd_src: torch.Tensor
    fwd_rel: torch.Tensor
    fwd_norm: torch.Tensor
    bwd_rowptr: torch.Tensor
    bwd_dst: torch.Tensor
    bwd_rel: torch.Tensor
    bwd_norm: torch.Tensor
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


def plan_span(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
              norm: np.ndarray, num_nodes: int, num_slots: int,
              device="cpu") -> SpanPlan:
    """Build the three edge layouts from per-edge ``(src, dst, rel, norm)``."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    rel = np.asarray(rel, np.int32)
    norm = np.asarray(norm, np.float32)
    e = src.shape[0]
    if not (dst.shape == rel.shape == norm.shape == (e,)):
        raise ValueError("src, dst, rel and norm must be 1-D of one length")
    if e >= 2**31 - 1:
        raise ValueError(f"{e} edges do not fit the kernels' int32 offsets")
    if e and (min(src.min(), dst.min()) < 0
              or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError("edge endpoint outside [0, num_nodes)")
    if e and (rel.min() < 0 or rel.max() >= num_slots):
        raise ValueError("relation outside [0, num_slots)")

    f_order, f_rowptr = _csr(dst, rel, num_nodes, num_slots)
    b_order, b_rowptr = _csr(src, rel, num_nodes, num_slots)
    r_order = np.argsort(rel.astype(np.int64) * max(num_nodes, 1) + src,
                         kind="stable")
    rel_counts = np.bincount(rel, minlength=num_slots)
    rel_edge_ptr = np.concatenate([[0], np.cumsum(rel_counts)]).astype(np.int64)

    n_chunk = -(-rel_counts // DW_CHUNK)
    rel_chunk_ptr = np.concatenate([[0], np.cumsum(n_chunk)]).astype(np.int32)
    chunk_rel = np.repeat(np.arange(num_slots), n_chunk)
    within = np.arange(chunk_rel.shape[0]) - rel_chunk_ptr[chunk_rel]
    chunk_lo = rel_edge_ptr[chunk_rel] + within * DW_CHUNK
    chunk_hi = np.minimum(chunk_lo + DW_CHUNK, rel_edge_ptr[chunk_rel + 1])

    t = lambda a, dtype=torch.int32: torch.as_tensor(
        np.ascontiguousarray(a)).to(dtype).to(device)
    return SpanPlan(
        num_nodes=int(num_nodes), num_slots=int(num_slots),
        fwd_rowptr=t(f_rowptr), fwd_src=t(src[f_order]),
        fwd_rel=t(rel[f_order]), fwd_norm=t(norm[f_order], torch.float32),
        bwd_rowptr=t(b_rowptr), bwd_dst=t(dst[b_order]),
        bwd_rel=t(rel[b_order]), bwd_norm=t(norm[b_order], torch.float32),
        rel_src=t(src[r_order]), rel_dst=t(dst[r_order]),
        rel_norm=t(norm[r_order], torch.float32),
        chunk_lo=t(chunk_lo), chunk_hi=t(chunk_hi),
        rel_chunk_ptr=t(rel_chunk_ptr),
        rel_edge_ptr=tuple(int(v) for v in rel_edge_ptr))


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


def span_backward_plain(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                        plan: SpanPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``span_backward`` with index_select, per-relation matmuls and
    index_add_, summed in ``_acc_dtype``."""
    acc = _acc_dtype(x.dtype)
    dx = torch.zeros(plan.num_nodes, w.shape[1], dtype=acc, device=x.device)
    dw = torch.zeros(w.shape, dtype=acc, device=x.device)
    for r, sl in _relation_slices(plan):
        t = (g_out.index_select(0, plan.rel_dst[sl]).to(acc)
             * plan.rel_norm[sl, None].to(acc))
        dx.index_add_(0, plan.rel_src[sl], t @ w[r].to(acc).T)
        dw[r] = x.index_select(0, plan.rel_src[sl]).to(acc).T @ t
    return dx, dw


# -- the CUDA kernels --------------------------------------------------------

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# ptxas report (registers, shared memory, spills) of this process's build
build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernels() -> Path:
    """Compile ``csrc/span_kernels.cu`` into a shared library (once per
    source and flags; the file name carries their hash) and return its
    path. Raises when ``nvcc`` fails."""
    global build_log
    digest = hashlib.sha256(_CSRC.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libspan_kernels_{digest}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_CSRC}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    build_log = res.stderr
    return so


def _kernels() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.span_rows.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
            lib.span_rows.restype = i
            lib.span_dw.argtypes = [i, p, p, p, p, p, p, p, p, p, p,
                                    i, i, i, i, p]
            lib.span_dw.restype = i
            lib.span_error_string.argtypes = [i]
            lib.span_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.span_error_string(err).decode()})")


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
    if x.shape[0] != plan.num_nodes or w.shape[0] != plan.num_slots:
        raise ValueError(f"plan has {plan.num_nodes} nodes and "
                         f"{plan.num_slots} slots, got x {tuple(x.shape)} "
                         f"and w {tuple(w.shape)}")


def _on_card(*tensors: torch.Tensor, plan: SpanPlan) -> bool:
    """True for CUDA tensors, False for CPU ones; raises otherwise."""
    kinds = {t.device.type for t in tensors} | {plan.device.type}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}
                                | {plan.device}) != 1:
        raise ValueError(f"span kernels need every tensor and the plan on "
                         f"one CUDA device (or all on the CPU), got {kinds}")
    return True


def _check_widths(d_in: int, d_out: int) -> None:
    if d_in > MAX_WIDTH or d_out > MAX_WIDTH or d_in * d_out > MAX_DW_ELEMS:
        raise ValueError(f"span kernels take d_in, d_out <= {MAX_WIDTH} and "
                         f"d_in * d_out <= {MAX_DW_ELEMS}, got {d_in}, {d_out}")


def _rows(lib, code, feat, wk, rowptr, idx, rel, norm, out, stream, what):
    n, k = feat.shape
    err = lib.span_rows(code, feat.data_ptr(), wk.data_ptr(),
                        rowptr.data_ptr(), idx.data_ptr(), rel.data_ptr(),
                        norm.data_ptr(), out.data_ptr(), n, k, out.shape[1],
                        wk.shape[0], stream)
    _check_launch(lib, err, what)


def span_forward(x: torch.Tensor, w: torch.Tensor,
                 plan: SpanPlan) -> torch.Tensor:
    """``out[n] = sum_{e: dst_e = n} norm_e * x[src_e] @ w[rel_e]``:
    ``x [N, d_in]``, ``w [slots, d_in, d_out]`` -> ``[N, d_out]`` float32."""
    _check_shapes(x, w, plan)
    if not _on_card(x, w, plan=plan):
        return span_forward_plain(x, w, plan)
    code = _cuda_dtype_code(x, w)
    _check_widths(x.shape[1], w.shape[2])
    lib = _kernels()
    out = torch.empty(plan.num_nodes, w.shape[2], dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _rows(lib, code, x, w, plan.fwd_rowptr, plan.fwd_src, plan.fwd_rel,
              plan.fwd_norm, out, stream, "span_forward")
    LAUNCHES["span_forward"] += 1
    return out


def span_backward(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  plan: SpanPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both aggregation gradients: ``g_out [N, d_out]`` (in ``w``'s dtype)
    -> ``dx [N, d_in]`` and ``dw [slots, d_in, d_out]``, float32."""
    _check_shapes(x, w, plan)
    if g_out.shape != (plan.num_nodes, w.shape[2]):
        raise ValueError(f"g_out {tuple(g_out.shape)} is not "
                         f"[{plan.num_nodes}, {w.shape[2]}]")
    if not _on_card(g_out, x, w, plan=plan):
        return span_backward_plain(g_out, x, w, plan)
    code = _cuda_dtype_code(g_out, x, w)
    slots, d_in, d_out = w.shape
    _check_widths(d_in, d_out)
    lib = _kernels()
    dev = x.device
    dx = torch.empty(plan.num_nodes, d_in, dtype=torch.float32, device=dev)
    dw = torch.empty(slots, d_in, d_out, dtype=torch.float32, device=dev)
    partial = torch.empty(max(plan.num_chunks, 1), d_in, d_out,
                          dtype=torch.float32, device=dev)
    # dx runs the forward's row kernel over the src-sorted CSR with W^T
    wt = w.transpose(1, 2).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _rows(lib, code, g_out, wt, plan.bwd_rowptr, plan.bwd_dst,
              plan.bwd_rel, plan.bwd_norm, dx, stream, "span_backward (dx)")
        err = lib.span_dw(code, x.data_ptr(), g_out.data_ptr(),
                          plan.chunk_lo.data_ptr(), plan.chunk_hi.data_ptr(),
                          plan.rel_chunk_ptr.data_ptr(),
                          plan.rel_src.data_ptr(), plan.rel_dst.data_ptr(),
                          plan.rel_norm.data_ptr(), partial.data_ptr(),
                          dw.data_ptr(), plan.num_chunks, slots, d_in, d_out,
                          stream)
        _check_launch(lib, err, "span_backward (dW)")
    LAUNCHES["span_backward"] += 1
    return dx, dw
