"""The attention head's fused self-attention: the CUDA kernels' wrappers,
their launch counters and the autograd function.

The attention head feeds the trunk with the first summary's row of a
multi-head self-attention over ``x [L, B, d]`` (``models/attention.py``
``mha_self_attention(...)[0]``). :class:`FirstQuery` computes that row
alone (``csrc/attention_kernels.cu`` says how): ``mha_forward`` packs the
parameters and launches the forward kernel; :class:`FirstQuery`'s backward
(``mha_backward``) recomputes the chain from ``x`` and the saved dropout
draw and writes the four parameter gradients and, when asked, ``dx``.
Nothing of size ``[L, B, 3d]`` is kept between the two.

The dropout draw is the plain route's ``[B, H, L, L]`` uniform tensor (the
kernels read its ``[:, :, 0, :]``: ``>= p`` keeps a weight, scaled by
``1 / (1 - p)``), so both routes take the same numbers from a generator.

:func:`fused_ok` says which inputs the kernels take: float32 on a card,
``L <= MAX_SUMS``, ``d <= MAX_WIDTH``, ``d % H == 0``, ``H <= MAX_SUMS``;
the wrappers take them contiguous.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build

# widest inputs the kernels take: summaries, width
MAX_SUMS = 8
MAX_WIDTH = 128

# (device index, L, B, d, H, pass) -> mha_plan's (T, resident, smem bytes,
# blocks, packed floats); pass -1 the forward, 0/1 the backward without/with
# dx. Planned outside any capture: a fit's eager warm-ups come first.
_plans: Dict[tuple, Tuple[int, ...]] = {}


def fused_ok(x: torch.Tensor, num_heads: int, *params: torch.Tensor) -> bool:
    """True when the kernels take ``x [L, B, d]`` with ``num_heads`` heads
    and the parameters ``params`` (once contiguous): all float32 on one
    card, ``1 <= L <= MAX_SUMS``, ``d <= MAX_WIDTH``, ``d % num_heads ==
    0`` and at most ``MAX_SUMS`` heads (the attention model has one a
    summary). Every such shape has a tile that fits in shared memory."""
    if x.dim() != 3 or not x.is_cuda:
        return False
    L, _, d = x.shape
    return (1 <= L <= MAX_SUMS and 1 <= d <= MAX_WIDTH
            and 1 <= num_heads <= MAX_SUMS and d % num_heads == 0
            and all(t.dtype == torch.float32 and t.device == x.device
                    for t in (x, *params)))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mha_plan.argtypes = [i, i, i, i, i, p]
    lib.mha_pack.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.mha_forward.argtypes = [p, p, p, p, i, i, i, i, f, f, f, i, i, i, i, p]
    lib.mha_backward.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                 f, f, f, i, i, i, i, p]
    for fn in (lib.mha_plan, lib.mha_pack, lib.mha_forward, lib.mha_backward):
        fn.restype = i


def _lib() -> ctypes.CDLL:
    return cuda_build.load("attention_kernels", _declare)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _plan(lib, x: torch.Tensor, num_heads: int, which: int) -> Tuple[int, ...]:
    """mha_plan's (T, resident, smem bytes, blocks, packed floats) of a pass
    (``which``: -1 the forward, 0/1 the backward without/with dx), planned
    once a shape. Call on x's card."""
    L, B, d = x.shape
    key = (x.device.index, L, B, d, num_heads, which)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * 5)()
        cuda_build.check_launch(lib, lib.mha_plan(L, B, d, num_heads, which,
                                                  out), "mha_plan")
        plan = _plans[key] = tuple(out)
    return plan


def _pack(lib, x, in_w, in_b, out_w, out_b, num_heads, packed_floats,
          stream) -> torch.Tensor:
    L, _, d = x.shape
    packed = torch.empty(packed_floats, dtype=torch.float32, device=x.device)
    cuda_build.check_launch(lib, lib.mha_pack(
        in_w.data_ptr(), in_b.data_ptr(), out_w.data_ptr(), out_b.data_ptr(),
        packed.data_ptr(), L, d, num_heads, stream), "mha_pack")
    return packed


def _scalars(dropout_rate: float, d: int, num_heads: int):
    """(p, 1 / (1 - p), 1 / sqrt(dh)) as the kernels take them."""
    keep = 1.0 / (1.0 - dropout_rate) if dropout_rate < 1.0 else 0.0
    return dropout_rate, keep, 1.0 / math.sqrt(d // num_heads)


def _check(x, in_w, in_b, out_w, out_b, draw, num_heads) -> None:
    params = (in_w, in_b, out_w, out_b)
    if not fused_ok(x, num_heads, *params) or \
            not all(t.is_contiguous() for t in (x, *params)):
        raise ValueError("the attention kernels take contiguous float32 "
                         f"inputs on one card, L <= {MAX_SUMS}, d <= "
                         f"{MAX_WIDTH}, d % heads == 0; got x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"{num_heads} heads")
    L, B, d = x.shape
    shapes = [(tuple(t.shape), want) for t, want in (
        (in_w, (3 * d, d)), (in_b, (3 * d,)), (out_w, (d, d)), (out_b, (d,)))]
    if draw is not None:
        shapes.append((tuple(draw.shape), (B, num_heads, L, L)))
        if draw.dtype != torch.float32 or not draw.is_contiguous() \
                or draw.device != x.device:
            raise ValueError("the dropout draw must be contiguous float32 on "
                             "x's card")
    for got, want in shapes:
        if got != want:
            raise ValueError(f"attention shapes: got {got}, want {want}")


def mha_forward(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor,
                out_w: torch.Tensor, out_b: torch.Tensor,
                draw: Optional[torch.Tensor], dropout_rate: float,
                num_heads: int) -> torch.Tensor:
    """``y [B, d]``, the first summary's attention output, on the card: the
    pack and forward kernels (one ``LAUNCHES["mha_forward"]``). ``draw``
    (``[B, H, L, L]``, or None: no dropout) as :class:`FirstQuery`."""
    _check(x, in_w, in_b, out_w, out_b, draw, num_heads)
    L, B, d = x.shape
    y = torch.empty(B, d, dtype=torch.float32, device=x.device)
    if B == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        T, resident, smem, blocks, floats = _plan(lib, x, num_heads, -1)
        packed = _pack(lib, x, in_w, in_b, out_w, out_b, num_heads, floats,
                       stream)
        err = lib.mha_forward(x.data_ptr(), _ptr(draw), packed.data_ptr(),
                              y.data_ptr(), L, B, d, num_heads,
                              *_scalars(dropout_rate, d, num_heads), T,
                              resident, smem, blocks, stream)
    cuda_build.check_launch(lib, err, "mha_forward")
    cuda_build.LAUNCHES["mha_forward"] += 1
    return y


def mha_backward(gy: torch.Tensor, x: torch.Tensor, in_w: torch.Tensor,
                 in_b: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
                 draw: Optional[torch.Tensor], dropout_rate: float,
                 num_heads: int, want_dx: bool):
    """The gradients of :func:`mha_forward` for ``gy [B, d]`` on the card:
    ``(dx or None, d_in_w, d_in_b, d_out_w, d_out_b)``; the pack, backward
    and reduce kernels (one ``LAUNCHES["mha_backward"]``)."""
    _check(x, in_w, in_b, out_w, out_b, draw, num_heads)
    L, B, d = x.shape
    if tuple(gy.shape) != (B, d) or gy.dtype != torch.float32 \
            or gy.device != x.device:
        raise ValueError(f"gy must be float32 [{B}, {d}] on x's card")
    gy = gy.contiguous()
    grads = [torch.empty_like(t) for t in (in_w, in_b, out_w, out_b)]
    dx = torch.empty_like(x) if want_dx else None
    if B == 0:
        for g in grads:
            g.zero_()
        return (dx, *grads)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        T, resident, smem, blocks, floats = _plan(lib, x, num_heads,
                                                  int(want_dx))
        packed = _pack(lib, x, in_w, in_b, out_w, out_b, num_heads, floats,
                       stream)
        partial = torch.empty(blocks, floats, dtype=torch.float32,
                              device=x.device)
        err = lib.mha_backward(x.data_ptr(), _ptr(draw), packed.data_ptr(),
                               gy.data_ptr(), _ptr(dx), partial.data_ptr(),
                               *(g.data_ptr() for g in grads), L, B, d,
                               num_heads, *_scalars(dropout_rate, d,
                                                    num_heads),
                               T, resident, smem, blocks, stream)
    cuda_build.check_launch(lib, err, "mha_backward")
    cuda_build.LAUNCHES["mha_backward"] += 1
    return (dx, *grads)


class FirstQuery(torch.autograd.Function):
    """``FirstQuery.apply(x, in_w, in_b, out_w, out_b, draw, dropout_rate,
    num_heads)``: the first summary's row of the self-attention of ``x [L,
    B, d]`` (torch ``MultiheadAttention`` parameter layouts) on the card,
    :func:`mha_forward` with :func:`mha_backward` as its gradient. ``draw``:
    the ``[B, H, L, L]`` uniform draw whose ``[:, :, 0, :] >= dropout_rate``
    keeps a weight, or None for no dropout. Saves ``x``, the draw and the
    parameters, nothing else."""

    @staticmethod
    def forward(ctx, x, in_w, in_b, out_w, out_b, draw, dropout_rate,
                num_heads):
        ctx.save_for_backward(x, in_w, in_b, out_w, out_b, draw)
        ctx.dropout_rate, ctx.num_heads = dropout_rate, num_heads
        return mha_forward(x, in_w, in_b, out_w, out_b, draw, dropout_rate,
                           num_heads)

    @staticmethod
    def backward(ctx, gy):
        x, in_w, in_b, out_w, out_b, draw = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = mha_backward(gy, x, in_w, in_b, out_w, out_b, draw,
                             ctx.dropout_rate, ctx.num_heads, need[0])
        return (*(g if want else None for g, want in zip(grads, need[:5])),
                None, None, None)
