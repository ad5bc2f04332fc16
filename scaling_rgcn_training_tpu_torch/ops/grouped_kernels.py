"""The grouped (per-relation) matmul and its weight gradient: CUDA kernel
wrappers with launch counters, their plain PyTorch versions, and the
autograd Function that joins them.

Counterpart of the JAX package's ``ops/pallas_kernels.py``:

- :func:`gmm` (``_fwd`` over ``_fwd_kernel``): for rows of ``lhs [M, K]``
  cut into consecutive groups of ``group_sizes[g]`` rows,
  ``out[rows of g] = lhs[rows of g] @ rhs[g]`` with ``rhs [G, K, N]``;
  ``out`` has ``lhs``'s dtype (bf16 in, bf16 out), every sum is float32;
- :func:`gmm_drhs` (``_drhs`` over ``_drhs_kernel``):
  ``d_rhs[g] = lhs[rows of g]^T @ gout[rows of g]`` -> ``[G, K, N]``
  float32 (float64 for float64), ``gout`` cast to ``lhs``'s dtype first;
- :class:`GroupedMatmul` (``grouped_matmul_pallas`` and its custom VJP):
  forward :func:`gmm`; backward :func:`gmm` on ``rhs`` transposed for
  ``d_lhs`` and :func:`gmm_drhs` for ``d_rhs``.

The kernels (``csrc/grouped_kernels.cu``) mask the ragged edge of the rows
themselves: the TPU version's padding of the rows to its tile is not carried
over. On the card :func:`gmm` and :func:`gmm_drhs` run on the tensor cores
(``gmm_tc_kernel``, ``drhs_tc_kernel``); their dataflows in PyTorch are
:func:`gmm_tiled_plain` and :func:`gmm_drhs_tiled_plain`. The earlier
routes on the CUDA cores stay callable as :func:`gmm_simt` and
:func:`gmm_drhs_simt`, each with its own launch counter; no main path calls
them. A wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build

# rows of one d_rhs partial sum (csrc/grouped_kernels.cu drhs_tc_kernel,
# drhs_partial_kernel)
DRHS_TILE_ROWS = 1024
# rows of one block of gmm_tc_kernel (its results do not depend on it)
GMM_TILE_ROWS = 1024
# the widest K that gmm_tc_kernel multiplies at once; a wider K is cut into
# chunks of this depth, each an f32 partial, added in chunk order
GMM_DEPTH = {torch.float32: 128, torch.bfloat16: 256}
# rows per step of the plain versions' [rows, K, N] intermediates
_PLAIN_ELEMS = 1 << 26


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def group_ids(group_sizes: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Row -> group id for consecutive groups of ``group_sizes`` rows."""
    g = group_sizes.shape[0]
    return torch.repeat_interleave(
        torch.arange(g, device=group_sizes.device), group_sizes.long(),
        output_size=num_rows)


def _check(lhs: torch.Tensor, group_sizes: torch.Tensor, k: int) -> None:
    if lhs.dim() != 2 or lhs.shape[1] != k or group_sizes.dim() != 1:
        raise ValueError(f"lhs {tuple(lhs.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} do not match [M, {k}] "
                         "and [G]")


def _row_steps(m: int, k: int, n: int):
    step = max(1, _PLAIN_ELEMS // max(k * n, 1))
    return ((lo, min(lo + step, m)) for lo in range(0, m, step))


# -- plain PyTorch versions ---------------------------------------------------

def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """:func:`gmm` as a per-row weight gather and a batched product in
    float32 (the JAX package's ``"gather"`` backend), in steps of rows.
    Differentiable."""
    _check(lhs, group_sizes, rhs.shape[1])
    m, n = lhs.shape[0], rhs.shape[2]
    acc = _acc_dtype(lhs.dtype)
    gid = group_ids(group_sizes, m)
    parts = [torch.bmm(lhs[lo:hi, None, :].to(acc),
                       rhs[gid[lo:hi]].to(acc))[:, 0]
             for lo, hi in _row_steps(m, rhs.shape[1], n)]
    out = torch.cat(parts) if parts else lhs.new_zeros(0, n, dtype=acc)
    return out.to(lhs.dtype)


def gmm_drhs_plain(lhs: torch.Tensor, gout: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """:func:`gmm_drhs` as per-row outer products summed into their group
    with ``index_add_``, in float32 (the JAX package's off-TPU dW)."""
    _check(lhs, group_sizes, lhs.shape[1])
    (m, k), n, g = lhs.shape, gout.shape[1], group_sizes.shape[0]
    acc = _acc_dtype(lhs.dtype)
    gout = gout.to(lhs.dtype)
    gid = group_ids(group_sizes, m)
    out = torch.zeros(g, k * n, dtype=acc, device=lhs.device)
    for lo, hi in _row_steps(m, k, n):
        pairs = lhs[lo:hi, :, None].to(acc) * gout[lo:hi, None, :].to(acc)
        out.index_add_(0, gid[lo:hi], pairs.reshape(hi - lo, k * n))
    return out.reshape(g, k, n)


def _group_spans(group_sizes: torch.Tensor, m: int):
    """``(g, lo, hi)`` of every group's rows ``[lo, hi)`` below ``m``."""
    offs = [0] + torch.cumsum(group_sizes.long(), 0).tolist()
    return [(g, min(lo, m), min(hi, m))
            for g, (lo, hi) in enumerate(zip(offs[:-1], offs[1:]))]


def gmm_tiled_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                    group_sizes: torch.Tensor) -> torch.Tensor:
    """:func:`gmm` in the CUDA kernel's dataflow (``gmm_tc_kernel``), for
    tests and chip_smoke.py: row tiles of ``GMM_TILE_ROWS`` rows; each
    tile's rows of each group it meets times that group's ``rhs``, in depth
    chunks of ``GMM_DEPTH`` features (one chunk up to that width), each
    chunk's product in float32 and the chunks added in order; each row
    written once, in ``lhs``'s dtype, by its own group's pass; rows past
    the last group 0."""
    _check(lhs, group_sizes, rhs.shape[1])
    (m, k), n = lhs.shape, rhs.shape[2]
    acc = _acc_dtype(lhs.dtype)
    depth = GMM_DEPTH.get(lhs.dtype, max(k, 1))
    out = torch.zeros(m, n, dtype=lhs.dtype, device=lhs.device)
    spans = _group_spans(group_sizes, m)
    for row0 in range(0, m, GMM_TILE_ROWS):
        row_end = min(row0 + GMM_TILE_ROWS, m)
        for g, lo, hi in spans:
            lo, hi = max(lo, row0), min(hi, row_end)
            if lo >= hi:
                continue
            total = None
            for k0 in range(0, k, depth):
                part = (lhs[lo:hi, k0:k0 + depth].to(acc)
                        @ rhs[g, k0:k0 + depth].to(acc))
                total = part if total is None else total + part
            if total is not None:
                out[lo:hi] = total.to(lhs.dtype)
    return out


def gmm_drhs_tiled_plain(lhs: torch.Tensor, gout: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """:func:`gmm_drhs` in the CUDA kernel's dataflow (``drhs_tc_kernel``
    and ``drhs_reduce_kernel``), for tests and chip_smoke.py: rows cut
    into tiles of ``DRHS_TILE_ROWS``; each (row tile i, group g) pair's
    partial ``lhs[rows]^T gout[rows]`` in float32 into slot ``i + g`` of
    the staircase; each group's partials added in row-tile order, 0 for an
    empty group. ``gout`` is cast to ``lhs``'s dtype first."""
    _check(lhs, group_sizes, lhs.shape[1])
    (m, k), n, g_n = lhs.shape, gout.shape[1], group_sizes.shape[0]
    acc = _acc_dtype(lhs.dtype)
    gout = gout.to(lhs.dtype)
    n_tiles = -(-m // DRHS_TILE_ROWS)
    partial = torch.zeros(max(n_tiles + g_n - 1, 1), k, n, dtype=acc,
                          device=lhs.device)
    spans = _group_spans(group_sizes, m)
    for i in range(n_tiles):
        row0 = i * DRHS_TILE_ROWS
        row_end = min(row0 + DRHS_TILE_ROWS, m)
        for g, lo, hi in spans:
            lo, hi = max(lo, row0), min(hi, row_end)
            if lo < hi:
                partial[i + g] = lhs[lo:hi].to(acc).T @ gout[lo:hi].to(acc)
    out = torch.zeros(g_n, k, n, dtype=acc, device=lhs.device)
    for g, lo, hi in spans:
        if lo < hi:
            for i in range(lo // DRHS_TILE_ROWS,
                           (hi - 1) // DRHS_TILE_ROWS + 1):
                out[g] += partial[i + g]
    return out


def _cost_ops(lhs: torch.Tensor, ops: int) -> Tuple[int, str]:
    """Operations on the tensor cores: three times for float32 (3xTF32,
    unit ``"tf32"``), once for bfloat16 (the kernels' fourth TF32 product
    is the design's own cost, not the function's)."""
    if lhs.dtype == torch.bfloat16:
        return ops, "bfloat16"
    return 3 * ops, "tf32"


def gmm_cost(lhs: torch.Tensor, rhs: torch.Tensor,
             group_sizes: torch.Tensor) -> Tuple[int, int, str]:
    """``(bytes, operations, unit)`` of :func:`gmm`'s function on these
    inputs, for its bound: ``lhs``, ``rhs`` and the group sizes read once,
    ``out`` in ``lhs``'s dtype written once; ``2 M K N`` operations."""
    (m, k), n = lhs.shape, rhs.shape[2]
    n_bytes = sum(t.numel() * t.element_size() for t in (lhs, rhs, group_sizes))
    n_bytes += m * n * lhs.element_size()
    return (n_bytes, *_cost_ops(lhs, 2 * m * k * n))


def gmm_drhs_cost(lhs: torch.Tensor, gout: torch.Tensor,
                  group_sizes: torch.Tensor) -> Tuple[int, int, str]:
    """``(bytes, operations, unit)`` of :func:`gmm_drhs`'s function on
    these inputs, for its bound: ``lhs``, ``gout`` in ``lhs``'s dtype and
    the group sizes read once, the ``[G, K, N]`` float32 output written
    once; ``2 M K N`` operations."""
    (m, k), n, g = lhs.shape, gout.shape[1], group_sizes.shape[0]
    n_bytes = (lhs.numel() + gout.numel()) * lhs.element_size()
    n_bytes += group_sizes.numel() * group_sizes.element_size() + 4 * g * k * n
    return (n_bytes, *_cost_ops(lhs, 2 * m * k * n))


# -- the CUDA kernels ---------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_matmul.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.grouped_matmul.restype = i
    lib.grouped_drhs.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
    lib.grouped_drhs.restype = i
    lib.grouped_matmul_simt.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.grouped_matmul_simt.restype = i
    lib.grouped_drhs_simt.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
    lib.grouped_drhs_simt.restype = i


def _dtype_code(*tensors: torch.Tensor) -> int:
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped kernels take float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"mixed dtypes {dtype} and {t.dtype}")
    if tensors[0].shape[0] >= 2**31 - 1:
        raise ValueError(f"{tensors[0].shape[0]} rows do not fit int32 offsets")
    return 1 if dtype == torch.bfloat16 else 0


def _offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """``[G + 1]`` int32 group offsets on the sizes' device (no host sync)."""
    offs = torch.zeros(group_sizes.shape[0] + 1, dtype=torch.int32,
                       device=group_sizes.device)
    offs[1:] = torch.cumsum(group_sizes, 0)
    return offs


def _check_gmm(lhs: torch.Tensor, rhs: torch.Tensor,
               group_sizes: torch.Tensor) -> None:
    if rhs.dim() != 3 or rhs.shape[0] != group_sizes.shape[0]:
        raise ValueError(f"rhs {tuple(rhs.shape)} is not [G, K, N] for "
                         f"{group_sizes.shape[0]} groups")
    _check(lhs, group_sizes, rhs.shape[1])


def _launch_gmm(lhs: torch.Tensor, rhs: torch.Tensor,
                group_sizes: torch.Tensor, simt: bool) -> torch.Tensor:
    """``grouped_matmul`` (tensor cores) or ``grouped_matmul_simt`` on the
    card."""
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    code = _dtype_code(lhs, rhs)
    (m, k), (g, _, n) = lhs.shape, rhs.shape
    # nothing to launch; a product over no depth, or rows in no group, is 0
    if m == 0 or n == 0 or g == 0 or (k == 0 and not simt):
        return torch.zeros(m, n, dtype=lhs.dtype, device=lhs.device)
    lib = cuda_build.load("grouped_kernels", _declare)
    out = torch.empty(m, n, dtype=lhs.dtype, device=lhs.device)
    offs = _offsets(group_sizes)
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if simt:
            name = "grouped_matmul_simt"
            err = lib.grouped_matmul_simt(code, lhs.data_ptr(), rhs.data_ptr(),
                                          offs.data_ptr(), out.data_ptr(), m,
                                          k, n, g, stream)
        else:
            name = "grouped_matmul"
            depth = GMM_DEPTH[lhs.dtype]
            chunks = -(-k // depth)
            partial = (torch.empty(chunks, m, n, dtype=torch.float32,
                                   device=lhs.device) if chunks > 1 else None)
            err = lib.grouped_matmul(code, lhs.data_ptr(), rhs.data_ptr(),
                                     offs.data_ptr(), out.data_ptr(),
                                     None if partial is None
                                     else partial.data_ptr(),
                                     m, k, n, g, GMM_TILE_ROWS, depth, stream)
    cuda_build.check_launch(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return out


def gmm(lhs: torch.Tensor, rhs: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """``lhs [M, K]``, ``rhs [G, K, N]``, ``group_sizes [G]`` -> ``[M, N]``
    in ``lhs``'s dtype; on the card ``gmm_tc_kernel`` (tensor cores)."""
    _check_gmm(lhs, rhs, group_sizes)
    if not cuda_build.on_card(lhs, rhs, group_sizes):
        return gmm_plain(lhs, rhs, group_sizes)
    return _launch_gmm(lhs, rhs, group_sizes, simt=False)


def gmm_simt(lhs: torch.Tensor, rhs: torch.Tensor,
             group_sizes: torch.Tensor) -> torch.Tensor:
    """:func:`gmm` by the earlier route on the CUDA cores (``gmm_kernel``),
    for timing and tests beside :func:`gmm`; no main path calls it."""
    _check_gmm(lhs, rhs, group_sizes)
    if not cuda_build.on_card(lhs, rhs, group_sizes):
        return gmm_plain(lhs, rhs, group_sizes)
    return _launch_gmm(lhs, rhs, group_sizes, simt=True)


def _launch_drhs(lhs: torch.Tensor, gout: torch.Tensor,
                 group_sizes: torch.Tensor, simt: bool) -> torch.Tensor:
    """``grouped_drhs`` (tensor cores) or ``grouped_drhs_simt`` on the
    card."""
    lhs = lhs.contiguous()
    gout = gout.to(lhs.dtype).contiguous()
    code = _dtype_code(lhs, gout)
    (m, k), n, g = lhs.shape, gout.shape[1], group_sizes.shape[0]
    dev = lhs.device
    if k == 0 or n == 0 or g == 0:   # nothing to launch
        return torch.zeros(g, k, n, dtype=torch.float32, device=dev)
    lib = cuda_build.load("grouped_kernels", _declare)
    out = torch.empty(g, k, n, dtype=torch.float32, device=dev)
    n_tiles = -(-m // DRHS_TILE_ROWS)
    partial = torch.empty(max(n_tiles + g - 1, 1), k, n, dtype=torch.float32,
                          device=dev)
    offs = _offsets(group_sizes)
    name = "grouped_drhs_simt" if simt else "grouped_drhs"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(code, lhs.data_ptr(), gout.data_ptr(),
                                 offs.data_ptr(), partial.data_ptr(),
                                 out.data_ptr(), m, k, n, g, DRHS_TILE_ROWS,
                                 stream)
    cuda_build.check_launch(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return out


def _check_drhs(lhs: torch.Tensor, gout: torch.Tensor,
                group_sizes: torch.Tensor) -> None:
    _check(lhs, group_sizes, lhs.shape[1])
    if gout.dim() != 2 or gout.shape[0] != lhs.shape[0]:
        raise ValueError(f"gout {tuple(gout.shape)} is not [{lhs.shape[0]}, N]")


def gmm_drhs(lhs: torch.Tensor, gout: torch.Tensor,
             group_sizes: torch.Tensor) -> torch.Tensor:
    """``lhs [M, K]``, ``gout [M, N]``, ``group_sizes [G]`` -> ``[G, K, N]``
    float32 (float64 for float64 ``lhs``); on the card ``drhs_tc_kernel``
    (tensor cores) and ``drhs_reduce_kernel``."""
    _check_drhs(lhs, gout, group_sizes)
    if not cuda_build.on_card(lhs, gout, group_sizes):
        return gmm_drhs_plain(lhs, gout, group_sizes)
    return _launch_drhs(lhs, gout, group_sizes, simt=False)


def gmm_drhs_simt(lhs: torch.Tensor, gout: torch.Tensor,
                  group_sizes: torch.Tensor) -> torch.Tensor:
    """:func:`gmm_drhs` by the earlier route on the CUDA cores
    (``drhs_partial_kernel``), for timing and tests beside
    :func:`gmm_drhs`; no main path calls it."""
    _check_drhs(lhs, gout, group_sizes)
    if not cuda_build.on_card(lhs, gout, group_sizes):
        return gmm_drhs_plain(lhs, gout, group_sizes)
    return _launch_drhs(lhs, gout, group_sizes, simt=True)


class GroupedMatmul(torch.autograd.Function):
    """:func:`gmm` with the kernels as its gradient: ``d_lhs`` is :func:`gmm`
    on ``rhs`` transposed per group, ``d_rhs`` is :func:`gmm_drhs`."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = gmm(g.to(lhs.dtype), rhs.transpose(1, 2), group_sizes)
        if ctx.needs_input_grad[1]:
            d_rhs = gmm_drhs(lhs, g, group_sizes).to(rhs.dtype)
        return d_lhs, d_rhs, None

