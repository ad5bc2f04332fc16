"""The featureless basis layer: the R-GCN paper's first layer, which reads
the node id (Schlichtkrull et al. 2018; PyG ``RGCNConv`` with ``x=None``).

With bases ``V [N, B, H]`` (a node's ``B x H`` block contiguous; PyG's
``weight[b, j]`` is ``V[j, b]``), ``comp [R, B]``, ``root [N, H]`` and
``bias [H]`` the layer is

    out[i] = root[i] + bias
             + sum_{e: dst_e = i} norm_e sum_b comp[rel_e, b] V[src_e, b]

PyG materialises ``W_r = sum_b comp[r, b] V[b]`` for every relation
(``[R, N, H]``, 17.8 GB at AM); nothing here does. Two routes:

- on a card, the CUDA kernels of ``csrc/basis_kernels.cu`` (which says
  how): :func:`basis_forward` and :func:`basis_backward`, bound into the
  autograd function :class:`BasisConv`. They read each node's block of
  ``V`` once a pass over the span plan's src-sorted CSR
  (``ops/span_kernels.py`` ``SpanPlan``), keep an ``[E, H]``
  message scratch in the forward and an ``[E, B]`` scratch of ``dcomp``
  terms in the backward, and sum in a fixed order (the same bits on two
  runs); float32 on the CUDA cores;
- elsewhere (the CPU), :func:`basis_conv_plain`: index_select, einsum and
  index_add over blocks of the relation-ordered edges, by autograd.

:func:`basis_conv` picks the route by the bases' device and counts each
call in the recorder (``utils/tracing.py``): ``basis.fused`` or
``basis.plain``. On a card a layer the kernels cannot take
(:func:`refusal`) and a failed build raise; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.utils import tracing

# the most bases and the widest output the kernels take
MAX_BASES = 64
MAX_WIDTH = 16
# relation-ordered edges a block of the plain route takes
PLAIN_BLOCK = 1 << 20


def refusal(bases: torch.Tensor, comp: torch.Tensor, root: torch.Tensor,
            bias: torch.Tensor, span) -> Optional[str]:
    """Why the kernels cannot take the layer, or None when they can: all
    float32 on one card with the span plan ``span`` (not None), ``bases
    [N, B, H]`` with ``1 <= B <= MAX_BASES`` and ``1 <= H <= MAX_WIDTH``,
    and ``N`` the plan's rows (``num_nodes == num_src``)."""
    if not bases.is_cuda:
        return f"the bases are on {bases.device}, not on a card"
    if span is None:
        return "the edges carry no span plan (built with span=False)"
    if bases.dim() != 3:
        return f"bases of shape {tuple(bases.shape)}, not [N, B, H]"
    n, B, H = bases.shape
    if not 1 <= B <= MAX_BASES:
        return f"{B} bases, outside 1..{MAX_BASES}"
    if not 1 <= H <= MAX_WIDTH:
        return f"width {H}, outside 1..{MAX_WIDTH}"
    if not span.num_nodes == span.num_src == n:
        return (f"{n} rows of bases against the plan's {span.num_nodes} "
                f"nodes and {span.num_src} sources")
    if span.device != bases.device:
        return f"the plan is on {span.device}, the bases on {bases.device}"
    for name, t in (("bases", bases), ("comp", comp), ("root", root),
                    ("bias", bias)):
        if t.dtype != torch.float32 or t.device != bases.device:
            return (f"{name} is {t.dtype} on {t.device}, not float32 on "
                    f"{bases.device}")
    return None


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.basis_forward.argtypes = [p] * 11 + [i] * 4 + [p]
    lib.basis_backward.argtypes = [p] * 15 + [i] * 5 + [p]
    for fn in (lib.basis_forward, lib.basis_backward):
        fn.restype = i


def _lib() -> ctypes.CDLL:
    return cuda_build.load("basis_kernels", _declare)


def _check(bases, comp, root, bias, span) -> None:
    why = refusal(bases, comp, root, bias, span)
    if why is None and not all(t.is_contiguous()
                               for t in (bases, comp, root, bias)):
        why = "a leaf is not contiguous"
    if why is not None:
        raise ValueError(f"the basis kernels cannot take the layer: {why}")
    n, B, H = bases.shape
    for t, want in ((comp, (span.num_slots, B)), (root, (n, H)),
                    (bias, (H,))):
        if tuple(t.shape) != want:
            raise ValueError(f"basis shapes: got {tuple(t.shape)}, want {want}")


def dst_to_src_positions(span) -> torch.Tensor:
    """Each dst-sorted edge's position in the src-sorted order of the span
    plan (int32 ``[E]``, on the plan's device): the forward writes its
    messages src-sorted and sums them dst-sorted."""
    e = span.bwd_pos.shape[0]
    at = torch.empty(e, dtype=torch.int32, device=span.device)
    at[span.bwd_pos.long()] = torch.arange(e, dtype=torch.int32,
                                           device=span.device)
    return at.index_select(0, span.fwd_pos.long())


def basis_forward(bases: torch.Tensor, comp: torch.Tensor, root: torch.Tensor,
                  bias: torch.Tensor, span, perm: torch.Tensor) -> torch.Tensor:
    """``out [N, H]`` on the card: ``basis_msg_kernel`` and
    ``basis_sum_kernel`` (one ``LAUNCHES["basis_forward"]``); ``perm``:
    :func:`dst_to_src_positions` of ``span``."""
    _check(bases, comp, root, bias, span)
    n, B, H = bases.shape
    e = int(span.bwd_pos.shape[0])
    out = torch.empty(n, H, dtype=torch.float32, device=bases.device)
    msg = torch.empty(e, H, dtype=torch.float32, device=bases.device)
    lib = _lib()
    with torch.cuda.device(bases.device):
        err = lib.basis_forward(
            bases.data_ptr(), comp.data_ptr(), root.data_ptr(),
            bias.data_ptr(), span.bwd_rowptr.data_ptr(),
            span.bwd_rel.data_ptr(), span.bwd_norm.data_ptr(),
            span.fwd_rowptr.data_ptr(), perm.data_ptr(), msg.data_ptr(),
            out.data_ptr(), n, B, H, e,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, "basis_forward")
    cuda_build.LAUNCHES["basis_forward"] += 1
    return out


def basis_backward(g: torch.Tensor, bases: torch.Tensor, comp: torch.Tensor,
                   span):
    """``(dV [N, B, H], dcomp [R, B])`` of :func:`basis_forward` for ``g
    [N, H]`` on the card: ``basis_bwd_kernel``,
    ``basis_dcomp_chunk_kernel`` and ``basis_dcomp_reduce_kernel`` (one
    ``LAUNCHES["basis_backward"]``)."""
    n, B, H = bases.shape
    if tuple(g.shape) != (n, H) or g.dtype != torch.float32 \
            or g.device != bases.device or not bases.is_contiguous():
        raise ValueError(f"g must be float32 [{n}, {H}] on the card of the "
                         "contiguous bases")
    g = g.contiguous()
    e = int(span.bwd_pos.shape[0])
    dv = torch.empty_like(bases)
    dcomp = torch.empty_like(comp)
    cterm = torch.empty(e, B, dtype=torch.float32, device=bases.device)
    partial = torch.empty(span.num_chunks, B, dtype=torch.float32,
                          device=bases.device)
    lib = _lib()
    with torch.cuda.device(bases.device):
        err = lib.basis_backward(
            bases.data_ptr(), comp.data_ptr(), g.data_ptr(),
            span.bwd_rowptr.data_ptr(), span.bwd_dst.data_ptr(),
            span.bwd_rel.data_ptr(), span.bwd_norm.data_ptr(),
            span.bwd_pos.data_ptr(), span.chunk_lo.data_ptr(),
            span.chunk_hi.data_ptr(), span.rel_chunk_ptr.data_ptr(),
            cterm.data_ptr(), partial.data_ptr(), dv.data_ptr(),
            dcomp.data_ptr(), n, B, H, span.num_chunks, span.num_slots,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, "basis_backward")
    cuda_build.LAUNCHES["basis_backward"] += 1
    return dv, dcomp


class BasisConv(torch.autograd.Function):
    """``BasisConv.apply(bases, comp, root, bias, span, perm)``: the layer
    on the card, :func:`basis_forward` with :func:`basis_backward` as its
    gradient (``droot = g``, ``dbias = g.sum(0)``). Saves the bases and
    ``comp``, nothing of the edges' size."""

    @staticmethod
    def forward(ctx, bases, comp, root, bias, span, perm):
        ctx.save_for_backward(bases, comp)
        ctx.span = span
        return basis_forward(bases, comp, root, bias, span, perm)

    @staticmethod
    def backward(ctx, g):
        bases, comp = ctx.saved_tensors
        need = ctx.needs_input_grad
        dv = dcomp = None
        if need[0] or need[1]:
            dv, dcomp = basis_backward(g, bases, comp, ctx.span)
        return (dv if need[0] else None, dcomp if need[1] else None,
                g if need[2] else None, g.sum(0) if need[3] else None,
                None, None)


def basis_conv_plain(bases: torch.Tensor, comp: torch.Tensor,
                     root: torch.Tensor, bias: torch.Tensor,
                     edges) -> torch.Tensor:
    """The layer in plain differentiable PyTorch over ``edges``
    (``ops/rgcn_conv.py`` ``RelEdges``: relation-ordered ``src``, ``dst``,
    ``rel``, ``norm``), ``PLAIN_BLOCK`` edges at a time: each edge's
    message ``sum_b (norm_e comp[rel_e, b]) bases[src_e, b]`` added onto
    ``root + bias``."""
    out = root + bias
    for lo in range(0, edges.num_edges, PLAIN_BLOCK):
        sl = slice(lo, lo + PLAIN_BLOCK)
        coef = comp.index_select(0, edges.rel[sl]) * \
            edges.norm[sl, None].to(comp.dtype)
        rows = bases.index_select(0, edges.src[sl])
        out = out.index_add(0, edges.dst[sl],
                            torch.einsum("kb,kbh->kh", coef, rows))
    return out


def basis_conv(edges, bases: torch.Tensor, comp: torch.Tensor,
               root: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The layer over ``edges`` (``RelEdges``): on a card
    :class:`BasisConv` (counter ``basis.fused``), raising where the kernels
    cannot take the layer (:func:`refusal`); elsewhere
    :func:`basis_conv_plain` (``basis.plain``)."""
    if not bases.is_cuda:
        tracing.count("basis.plain")
        return basis_conv_plain(bases, comp, root, bias, edges)
    why = refusal(bases, comp, root, bias, edges.span)
    if why is not None:
        raise ValueError(f"the basis kernels cannot take the layer: {why}")
    tracing.count("basis.fused")
    return BasisConv.apply(bases.contiguous(), comp.contiguous(),
                           root.contiguous(), bias.contiguous(),
                           edges.span, edges.basis_perm)
