"""Kernel #8: the span conv's backward in one pass, with its attribution
variants, a launch counter and plain PyTorch versions.

The JAX package's ``scripts/bwd_variants.py`` times variants of a one-pass
backward Pallas kernel (``make_bwd``'s ``kernel``) that switch parts of the
work off, to say where the backward's time goes. Here that kernel is
hand-written CUDA for ``sm_90a`` (``csrc/bwd_variants.cu``) over the port's
src-sorted CSR (``SpanPlan.bwd_*``), computing in one pass

- ``dx[n] = sum_{e: src_e = n} norm_e * g_out[dst_e] @ w[rel_e]^T``;
- ``dw[r] = sum_{e: rel_e = r} x[src_e]^T (norm_e * g_out[dst_e])``,

both float32, from float32 or bfloat16 ``g_out``/``x``/``w``. Variants
(:data:`VARIANTS`): ``base`` (both), ``nodw`` (dx only: ``dw`` is None),
``nodx`` (dW only: ``dx`` is None) and ``statrmw`` (every edge's dW added
into the first relation slot of its relation pass: wrong math, kept for
its time). #8 reads ``g_out[dst]`` once, over the src-sorted CSR; so
does the shipped backward (#2, ``span_kernels.span_backward``), over the
relation chunks on the tensor cores, while its earlier route
(``span_backward_rows``) read it twice, once for dx and once for dW.

#8's dW is summed with shared-memory atomics, so two runs may differ in
the last bits; it is held to a tolerance. A wrapper runs the plain version
when its tensors lie on the CPU, launches the kernel when they lie on a
CUDA device, and raises otherwise; a failed build raises.
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

VARIANTS = ("base", "nodw", "nodx", "statrmw")
# shared memory a block may use on sm_90 (csrc/span_rows.cuh kMaxSmem)
MAX_SMEM = 232448

Pair = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


# -- plans of the microbench rows ---------------------------------------------

def plan_edge_arrays(plan: sk.SpanPlan):
    """``(src, dst, rel, norm)`` numpy arrays of a plan's edges, in its
    src-sorted order."""
    counts = np.diff(plan.bwd_rowptr.cpu().numpy())
    src = np.repeat(np.arange(plan.num_src, dtype=np.int32), counts)
    return (src, plan.bwd_dst.cpu().numpy(), plan.bwd_rel.cpu().numpy(),
            plan.bwd_norm.cpu().numpy())


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

def pass_rels(variant: str, dtype: torch.dtype, d_in: int, d_out: int,
              num_slots: int) -> int:
    """Relations per shared-memory pass of the kernel (the split of
    ``csrc/bwd_variants.cu`` ``plan_launch``); ``statrmw``'s math depends
    on it."""
    size = 2 if dtype == torch.bfloat16 else 4
    per_rel = d_in * d_out * ((size if variant != "nodx" else 0)
                              + (4 if variant != "nodw" else 0))
    n_pass = -(-num_slots // max(MAX_SMEM // per_rel, 1))
    return -(-num_slots // n_pass)


def span_backward_variant_plain(g_out: torch.Tensor, x: torch.Tensor,
                                w: torch.Tensor, plan: sk.SpanPlan,
                                variant: str = "base") -> Pair:
    """The variant's outputs from ``span_backward_plain``; ``statrmw``'s
    dW slot ``r_lo`` of each relation pass ``[r_lo, r_hi)`` holds the sum
    of the pass's dW, the other slots 0."""
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


# -- the CUDA kernel ----------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bwd_variant_grid.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
    lib.bwd_variant_grid.restype = i
    lib.bwd_variant.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i, i,
                                i, i, p]
    lib.bwd_variant.restype = i
    lib.bwd_floor.argtypes = [p]
    lib.bwd_floor.restype = i


def _kernels() -> ctypes.CDLL:
    return cuda_build.load("bwd_variants", _declare)


@functools.lru_cache(maxsize=64)
def _grid(device: int, variant: int, code: int, d_in: int, d_out: int,
          slots: int, n_rows: int) -> int:
    lib = _kernels()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.bwd_variant_grid(variant, code, d_in, d_out, slots, n_rows,
                                   ctypes.byref(blocks))
    cuda_build.check_launch(lib, err, "span_backward_variant (grid)")
    return blocks.value


def span_backward_variant(g_out: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, plan: sk.SpanPlan,
                          variant: str = "base") -> Pair:
    """``(dx [num_src, d_in], dw [slots, d_in, d_out])``, float32, of one
    variant (``nodw``: ``dw`` None; ``nodx``: ``dx`` None)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    sk._check_shapes(x, w, plan)
    if g_out.shape != (plan.num_nodes, w.shape[2]):
        raise ValueError(f"g_out {tuple(g_out.shape)} is not "
                         f"[{plan.num_nodes}, {w.shape[2]}]")
    if not cuda_build.on_card(g_out, x, w, plan.bwd_dst):
        return span_backward_variant_plain(g_out, x, w, plan, variant)
    code = sk._cuda_dtype_code(g_out, x, w)
    slots, d_in, d_out = w.shape
    sk._check_widths(d_in, d_out)
    lib = _kernels()
    dev = x.device
    v = VARIANTS.index(variant)
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
    cuda_build.check_launch(lib, err, f"span_backward_variant ({variant})")
    LAUNCHES["span_backward_variant"] += 1
    return dx, dw


def floor_launch(device) -> None:
    """One empty kernel launch on ``device``'s current stream: the
    microbench harness's floor (counted nowhere)."""
    lib = _kernels()
    with torch.cuda.device(device):
        err = lib.bwd_floor(torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, "bwd_floor")
