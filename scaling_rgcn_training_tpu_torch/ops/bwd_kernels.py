"""Kernel #8: the span conv's backward in one pass, with its attribution
variants, launch counters and plain PyTorch versions.

The JAX package's ``scripts/bwd_variants.py`` times variants of a one-pass
backward Pallas kernel (``make_bwd``'s ``kernel``) that switch parts of the
work off, to say where the backward's time goes. Here that kernel is
hand-written CUDA for ``sm_90a`` (``csrc/bwd_variants.cu``), computing in
one pass

- ``dx[n] = sum_{e: src_e = n} norm_e * g_out[dst_e] @ w[rel_e]^T``;
- ``dw[r] = sum_{e: rel_e = r} x[src_e]^T (norm_e * g_out[dst_e])``,

both float32, from float32 or bfloat16 ``g_out``/``x``/``w``, by two
routes:

- :func:`span_backward_variant`, ``bwd_tc_kernel``: the TPU kernel's own
  design on the tensor cores over a bucket plan (:func:`plan_buckets`:
  edges sorted by ``(src // B, rel, src)``). A block keeps a bucket's x
  rows and dx accumulator in shared memory across its relations, and a
  pass of relations' dW beside them; each (bucket, relation) segment's dx
  messages (``mma.sync``) are added into the dx rows in edge order and its
  dW tiles summed by the warps that own them, so no atomics and no
  ``[E, d_in]`` scratch; the same bits on every run. Variants
  (:data:`VARIANTS`): ``base`` (both), ``nodw`` (dx only: ``dw`` is None),
  ``nodx`` (dW only: ``dx`` is None) and ``tf32`` (float32 inputs with one
  TF32 product per multiply-add instead of the split: wrong bits, kept to
  time the split; bfloat16 inputs run ``base``).
- :func:`span_backward_variant_simt`, ``bwd_variant_kernel``: the earlier
  route on the CUDA cores over the src-sorted CSR (``SpanPlan.bwd_*``), one
  warp per src row, dW summed with shared-memory atomics, so two runs may
  differ in dW's last bits and it is held to a tolerance. Variants
  (:data:`SIMT_VARIANTS`): ``base``, ``nodw``, ``nodx`` and ``statrmw``
  (every edge's dW added into the first relation slot of its relation
  pass: wrong math, kept for its time).

No main path calls either: the shipped backward is #2
(``span_kernels.span_backward``). The launch counters are
``span_backward_variant`` and ``span_backward_variant_simt``. A wrapper
runs the plain version when its tensors lie on the CPU, launches the
kernel when they lie on a CUDA device, and raises otherwise; a failed
build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.utils.plantree import to_device

VARIANTS = ("base", "nodw", "nodx", "tf32")
SIMT_VARIANTS = ("base", "nodw", "nodx", "statrmw")
# src rows of a bucket of the redesign's plan
BUCKET_ROWS = 128
# shared memory a block may use on sm_90 (csrc/span_rows.cuh kMaxSmem)
MAX_SMEM = 232448

Pair = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


# -- plans of the microbench rows ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The redesign's edge layout: the edges of ``span`` sorted by
    ``(src // bucket_rows, rel, src)`` (ties in the src-sorted CSR's order),
    per edge ``dst`` (int32), ``norm`` (float32) and ``row`` (int16,
    ``src - bucket * bucket_rows``); bucket ``b``'s edges of relation ``r``
    are ``seg_ptr[b * slots + r]:seg_ptr[b * slots + r + 1]`` (int32,
    ``[num_buckets * slots + 1]``)."""

    span: sk.SpanPlan
    bucket_rows: int
    num_buckets: int
    seg_ptr: torch.Tensor
    dst: torch.Tensor
    norm: torch.Tensor
    row: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.dst.device


def plan_edge_arrays(plan: sk.SpanPlan):
    """``(src, dst, rel, norm)`` numpy arrays of a plan's edges, in its
    src-sorted order."""
    counts = np.diff(plan.bwd_rowptr.cpu().numpy())
    src = np.repeat(np.arange(plan.num_src, dtype=np.int32), counts)
    return (src, plan.bwd_dst.cpu().numpy(), plan.bwd_rel.cpu().numpy(),
            plan.bwd_norm.cpu().numpy())


def plan_buckets(plan: sk.SpanPlan,
                 bucket_rows: int = BUCKET_ROWS) -> BucketPlan:
    """The bucket plan of ``plan``'s edges, built with numpy on the CPU and
    moved to the plan's device. One src row's edges keep the relation
    order of the src-sorted CSR that #2's dx sum walks."""
    if not 1 <= bucket_rows <= 2**15:
        raise ValueError(f"bucket_rows {bucket_rows} is not in [1, 32768]")
    src, dst, rel, norm = plan_edge_arrays(plan)
    slots = plan.num_slots
    num_buckets = -(-plan.num_src // bucket_rows)
    bucket = src // bucket_rows
    key = bucket.astype(np.int64) * slots + rel
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=num_buckets * slots)
    seg_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    t = lambda a, dtype: torch.as_tensor(np.ascontiguousarray(a, dtype))
    buckets = BucketPlan(
        span=plan, bucket_rows=int(bucket_rows), num_buckets=int(num_buckets),
        seg_ptr=t(seg_ptr, np.int32), dst=t(dst[order], np.int32),
        norm=t(norm[order], np.float32),
        row=t((src - bucket * bucket_rows)[order], np.int16))
    return to_device(buckets, plan.device)


def fold_dst(plan: sk.SpanPlan, window: int = 4096) -> sk.SpanPlan:
    """The plan with every ``dst`` folded into ``[0, window)``
    (``dst % window``), so the ``g_out[dst]`` gather stays in L2; the
    ``noonehot`` row of the microbench (the TPU variant dropped the one-hot
    matrix that is its gather)."""
    src, dst, rel, norm = plan_edge_arrays(plan)
    return sk.plan_span(src, dst % window, rel, norm, plan.num_nodes,
                        plan.num_slots, device=plan.device,
                        num_src=plan.num_src)


def reverse_plan(plan: sk.SpanPlan) -> sk.SpanPlan:
    """The plan with ``src`` and ``dst`` swapped, so that a forward over it
    with ``w^T`` computes the backward's dx (the ``fwdrev`` row: the
    earlier route's dx half alone, through ``span_forward_rows``). The
    relation order stays, so the two CSRs swap their positions in it."""
    return dataclasses.replace(
        plan, num_nodes=plan.num_src, num_src=plan.num_nodes,
        fwd_rowptr=plan.bwd_rowptr, fwd_src=plan.bwd_dst,
        fwd_rel=plan.bwd_rel, fwd_norm=plan.bwd_norm, fwd_pos=plan.bwd_pos,
        bwd_rowptr=plan.fwd_rowptr, bwd_dst=plan.fwd_src,
        bwd_rel=plan.fwd_rel, bwd_norm=plan.fwd_norm, bwd_pos=plan.fwd_pos,
        rel_src=plan.rel_dst, rel_dst=plan.rel_src)


# -- plain PyTorch versions ---------------------------------------------------

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits), to nearest even,
    as ``csrc/span_tc.cuh`` ``tf32_round`` does (infinities and NaNs kept)."""
    u = t.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    finite = (u & 0x7F800000) != 0x7F800000
    r = torch.where(finite, (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000, u)
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32)


def _backward_tf32_plain(g_out, x, w, plan: sk.SpanPlan):
    """``span_backward_plain`` with the operands rounded to TF32 as the
    tf32 variant rounds them (``norm * g_out`` in float32, then rounded;
    ``x`` and ``w`` rounded), summed in float32."""
    dx = torch.zeros(plan.num_src, w.shape[1], dtype=torch.float32,
                     device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    xr, wr = tf32_round(x), tf32_round(w)
    for r, sl in sk._relation_slices(plan):
        t = tf32_round(g_out.index_select(0, plan.rel_dst[sl]).float()
                       * plan.rel_norm[sl, None])
        dx.index_add_(0, plan.rel_src[sl], t @ wr[r].T)
        dw[r] = xr.index_select(0, plan.rel_src[sl]).T @ t
    return dx, dw


def span_backward_variant_plain(g_out: torch.Tensor, x: torch.Tensor,
                                w: torch.Tensor, buckets: BucketPlan,
                                variant: str = "base") -> Pair:
    """The redesign's variant from ``span_backward_plain`` on the bucket
    plan's edges; ``tf32`` (float32) with the operands rounded to TF32
    first."""
    if variant == "tf32" and x.dtype == torch.float32:
        dx, dw = _backward_tf32_plain(g_out, x, w, buckets.span)
    else:
        dx, dw = sk.span_backward_plain(g_out, x, w, buckets.span)
    return (None if variant == "nodx" else dx,
            None if variant == "nodw" else dw)


def pass_rels(variant: str, dtype: torch.dtype, d_in: int, d_out: int,
              num_slots: int) -> int:
    """Relations per shared-memory pass of the earlier route (the split of
    ``csrc/bwd_variants.cu`` ``plan_launch``); ``statrmw``'s math depends
    on it."""
    size = 2 if dtype == torch.bfloat16 else 4
    per_rel = d_in * d_out * ((size if variant != "nodx" else 0)
                              + (4 if variant != "nodw" else 0))
    n_pass = -(-num_slots // max(MAX_SMEM // per_rel, 1))
    return -(-num_slots // n_pass)


def span_backward_variant_simt_plain(g_out: torch.Tensor, x: torch.Tensor,
                                     w: torch.Tensor, plan: sk.SpanPlan,
                                     variant: str = "base") -> Pair:
    """The earlier route's variant from ``span_backward_plain``;
    ``statrmw``'s dW slot ``r_lo`` of each relation pass ``[r_lo, r_hi)``
    holds the sum of the pass's dW, the other slots 0."""
    dx, dw = sk.span_backward_plain(g_out, x, w, plan)
    if variant == "statrmw":
        step = pass_rels(variant, w.dtype, w.shape[1], w.shape[2],
                         plan.num_slots)
        stat = torch.zeros_like(dw)
        for r_lo in range(0, plan.num_slots, step):
            stat[r_lo] = dw[r_lo:r_lo + step].sum(0)
        dw = stat
    return (None if variant == "nodx" else dx,
            None if variant == "nodw" else dw)


# -- the CUDA kernels ---------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bwd_variant_grid.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
    lib.bwd_variant_grid.restype = i
    lib.bwd_variant.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i, i,
                                i, i, p]
    lib.bwd_variant.restype = i
    lib.bwd_tc_grid.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(i)]
    lib.bwd_tc_grid.restype = i
    lib.bwd_tc.argtypes = [i, i, *[p] * 11, i, i, i, i, i, i, i, p]
    lib.bwd_tc.restype = i
    lib.bwd_floor.argtypes = [p]
    lib.bwd_floor.restype = i


def _kernels() -> ctypes.CDLL:
    return cuda_build.load("bwd_variants", _declare)


def _check_call(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                plan: sk.SpanPlan, variant: str, variants) -> None:
    if variant not in variants:
        raise ValueError(f"variant {variant!r} is not one of {variants}")
    sk._check_shapes(x, w, plan)
    if g_out.shape != (plan.num_nodes, w.shape[2]):
        raise ValueError(f"g_out {tuple(g_out.shape)} is not "
                         f"[{plan.num_nodes}, {w.shape[2]}]")


@functools.lru_cache(maxsize=64)
def _tc_grid(device: int, variant: int, code: int, d_in: int, d_out: int,
             bucket_rows: int, slots: int, num_buckets: int
             ) -> Tuple[int, int, int, int]:
    """``(blocks, relations a pass, staged W bytes a relation, tiles a
    stage)`` of a launch of the redesign."""
    lib = _kernels()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.bwd_tc_grid(variant, code, d_in, d_out, bucket_rows, slots,
                              num_buckets, out)
    if err != 0:
        raise ValueError(
            f"span_backward_variant: widths {d_in} -> {d_out} with "
            f"{bucket_rows} bucket rows do not fit a block (CUDA error {err}:"
            f" {lib.kernel_error_string(err).decode()}); build the bucket "
            "plan with fewer rows")
    return out[0], out[1], out[2], out[3]


def tc_launch_shape(g_out: torch.Tensor, w: torch.Tensor,
                    buckets: BucketPlan, variant: str = "base"
                    ) -> Tuple[int, int, int]:
    """``(blocks, relations a pass, 16-edge tiles a stage)`` of the
    redesign's launch on the card: the persistent grid, the relation
    passes and the stage size its buffers allow."""
    dev = w.device
    blocks, rels, _, tiles = _tc_grid(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        VARIANTS.index(variant), sk._cuda_dtype_code(g_out, w), w.shape[1],
        w.shape[2], buckets.bucket_rows, w.shape[0], buckets.num_buckets)
    return blocks, rels, tiles


def span_backward_variant(g_out: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, buckets: BucketPlan,
                          variant: str = "base") -> Pair:
    """``(dx [num_src, d_in], dw [slots, d_in, d_out])``, float32, of one
    variant of the redesign (``nodw``: ``dw`` None; ``nodx``: ``dx``
    None). On the card three kernels of ``csrc/bwd_variants.cu``: W's
    staged layout (dx variants), ``bwd_tc_kernel``, and the block-ordered
    sum of its dW partials (dW variants)."""
    _check_call(g_out, x, w, buckets.span, variant, VARIANTS)
    if not cuda_build.on_card(g_out, x, w, buckets.dst):
        return span_backward_variant_plain(g_out, x, w, buckets, variant)
    return _launch_tc(_kernels(), g_out, x, w, buckets, variant)


def _launch_tc(lib: ctypes.CDLL, g_out: torch.Tensor, x: torch.Tensor,
               w: torch.Tensor, buckets: BucketPlan, variant: str) -> Pair:
    plan = buckets.span
    code = sk._cuda_dtype_code(g_out, x, w)
    slots, d_in, d_out = w.shape
    sk._check_widths(d_in, d_out)
    dev = x.device
    v = VARIANTS.index(variant)
    blocks, _, w_bytes, _ = _tc_grid(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        v, code, d_in, d_out, buckets.bucket_rows, slots, buckets.num_buckets)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = dw = partial = wsplit = None
    if variant != "nodx":
        dx = torch.empty(plan.num_src, d_in, **f32)
        wsplit = torch.empty(slots * w_bytes, dtype=torch.uint8, device=dev)
    if variant != "nodw":
        dw = torch.empty(slots, d_in, d_out, **f32)
        partial = torch.empty(max(blocks, 1), slots, d_in, d_out, **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.bwd_tc(v, code, g_out.data_ptr(), x.data_ptr(), w.data_ptr(),
                         buckets.seg_ptr.data_ptr(), buckets.dst.data_ptr(),
                         buckets.norm.data_ptr(), buckets.row.data_ptr(),
                         ptr(wsplit), ptr(partial), ptr(dx), ptr(dw),
                         plan.num_src, buckets.num_buckets,
                         buckets.bucket_rows, d_in, d_out, slots, blocks,
                         torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, f"span_backward_variant ({variant})")
    LAUNCHES["span_backward_variant"] += 1
    return dx, dw


@functools.lru_cache(maxsize=64)
def _grid(device: int, variant: int, code: int, d_in: int, d_out: int,
          slots: int, n_rows: int) -> int:
    lib = _kernels()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.bwd_variant_grid(variant, code, d_in, d_out, slots, n_rows,
                                   ctypes.byref(blocks))
    cuda_build.check_launch(lib, err, "span_backward_variant_simt (grid)")
    return blocks.value


def span_backward_variant_simt(g_out: torch.Tensor, x: torch.Tensor,
                               w: torch.Tensor, plan: sk.SpanPlan,
                               variant: str = "base") -> Pair:
    """``(dx [num_src, d_in], dw [slots, d_in, d_out])``, float32, of one
    variant of the earlier route on the CUDA cores (``nodw``: ``dw`` None;
    ``nodx``: ``dx`` None)."""
    _check_call(g_out, x, w, plan, variant, SIMT_VARIANTS)
    if not cuda_build.on_card(g_out, x, w, plan.bwd_dst):
        return span_backward_variant_simt_plain(g_out, x, w, plan, variant)
    code = sk._cuda_dtype_code(g_out, x, w)
    slots, d_in, d_out = w.shape
    sk._check_widths(d_in, d_out)
    lib = _kernels()
    dev = x.device
    v = SIMT_VARIANTS.index(variant)
    blocks = _grid(dev.index if dev.index is not None
                   else torch.cuda.current_device(),
                   v, code, d_in, d_out, slots, plan.num_src)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(plan.num_src, d_in, **f32) if variant != "nodx" else None
    dw = partial = None
    if variant != "nodw":
        dw = torch.empty(slots, d_in, d_out, **f32)
        partial = torch.empty(max(blocks, 1), slots, d_out, d_in, **f32)
    wt = w.transpose(1, 2).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bwd_variant(v, code, g_out.data_ptr(), x.data_ptr(),
                              wt.data_ptr(), plan.bwd_rowptr.data_ptr(),
                              plan.bwd_dst.data_ptr(), plan.bwd_rel.data_ptr(),
                              plan.bwd_norm.data_ptr(), ptr(dx), ptr(partial),
                              ptr(dw), plan.num_src, d_in, d_out, slots,
                              blocks, stream)
    cuda_build.check_launch(lib, err,
                            f"span_backward_variant_simt ({variant})")
    LAUNCHES["span_backward_variant_simt"] += 1
    return dx, dw


# phases of bwd_tc_kernel's stage loop timed by its -DBWD_TC_PHASES build
PHASES = ("bucket set-up", "stage walk, edge loads", "copies wait",
          "scale, split, rows", "barrier 1", "gather and W issue",
          "dx products", "dW products", "barrier 2", "run adds", "dW flush",
          "bucket store", "pass end")


def _declare_phases(lib: ctypes.CDLL) -> None:
    _declare(lib)
    lib.bwd_tc_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bwd_tc_phases.restype = ctypes.c_int


def tc_phases(g_out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              buckets: BucketPlan, variant: str = "base") -> dict:
    """Where one launch of the redesign's kernel spends its time, on the
    card: ``bwd_tc_kernel`` built with ``-DBWD_TC_PHASES`` (its own library)
    times each phase of its stage loop (:data:`PHASES`) with warp 0's
    ``clock64``; returned per block, averaged over the blocks: the stages
    and bucket passes, the cycles of the whole launch and each phase's
    cycles per stage. Counted as a launch of ``span_backward_variant``."""
    _check_call(g_out, x, w, buckets.span, variant, VARIANTS)
    if not cuda_build.on_card(g_out, x, w, buckets.dst):
        raise ValueError("tc_phases times the kernel on the card")
    lib = cuda_build.load("bwd_variants", _declare_phases,
                          define="BWD_TC_PHASES")
    blocks = tc_launch_shape(g_out, w, buckets, variant)[0]
    counts = np.zeros((1024, 16), np.uint64)
    with torch.cuda.device(x.device):
        err = lib.bwd_tc_phases(None, 1)
        cuda_build.check_launch(lib, err, "bwd_tc_phases (reset)")
        _launch_tc(lib, g_out, x, w, buckets, variant)
        err = lib.bwd_tc_phases(counts.ctypes.data, 0)
        cuda_build.check_launch(lib, err, "bwd_tc_phases (read)")
    per_block = counts[:min(blocks, 1024)].astype(np.float64).mean(0)
    stages = max(per_block[13], 1.0)
    return {"stages": float(per_block[13]),
            "bucket_passes": float(per_block[14]),
            "cycles": float(per_block[:len(PHASES)].sum()),
            "cycles_per_stage": {name: float(per_block[i] / stages)
                                 for i, name in enumerate(PHASES)}}


def floor_launch(device) -> None:
    """One empty kernel launch on ``device``'s current stream: the
    microbench harness's floor (counted nowhere)."""
    lib = _kernels()
    with torch.cuda.device(device):
        err = lib.bwd_floor(torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, "bwd_floor")
