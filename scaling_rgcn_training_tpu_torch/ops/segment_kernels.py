"""Sorted-key segment sum: the CUDA kernel's wrapper, its launch counter and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/segment_kernels.py``
(``sorted_segment_sum_pallas`` over ``_seg_kernel``) together with the two
passes its callers run before it (``ops/rgcn_conv.py``: the ``norm``
scale, then the gather of the values into key order)::

    out[k] = sum_{e = rowptr[k]}^{rowptr[k+1]-1} scale[perm[e]] * vals[perm[e]]

``perm`` and ``scale`` are optional (without ``perm`` the values are in
key order; ``scale`` is in ``vals``' order). The TPU version plans buckets
of output rows and chunks of values and reduces one-hot tiles on the MXU;
the port's plan is a CSR row pointer ``[M + 1]`` over the sorted keys
(:func:`segment_rowptr`), and the kernel (``csrc/segment_kernels.cu``)
gives whole output rows to groups of lanes that gather their values through
``perm`` and add them in edge order. :func:`sorted_segment_sum_rows` is the
earlier route (the scale and the gather as separate passes, then the
kernel of values in key order), which gives the same bits; no main path
calls it.

``vals`` is float32 or bfloat16 (float64 on the CPU, for gradcheck); sums
and the result are float32 for both (float64 for float64), as the TPU
version returns float32 for low-precision input.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build


def segment_rowptr(keys: np.ndarray, num_segments: int) -> np.ndarray:
    """Host-side: the CSR row pointer ``[num_segments + 1]`` (int32) of
    ascending ``keys``; row ``k``'s values are ``rowptr[k]:rowptr[k+1]``."""
    keys = np.asarray(keys, np.int64)
    if keys.size and (keys[0] < 0 or keys[-1] >= num_segments
                      or np.any(keys[1:] < keys[:-1])):
        raise ValueError("keys must be ascending and inside [0, num_segments)")
    counts = np.bincount(keys, minlength=num_segments)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check(vals: torch.Tensor, rowptr: torch.Tensor,
           perm: Optional[torch.Tensor], scale: Optional[torch.Tensor]) -> None:
    if vals.dim() != 2 or rowptr.dim() != 1 or rowptr.numel() < 1:
        raise ValueError(f"vals {tuple(vals.shape)} and rowptr "
                         f"{tuple(rowptr.shape)} are not [E, h] and [M + 1]")
    if rowptr.dtype != torch.int32:
        raise TypeError(f"rowptr must be int32, got {rowptr.dtype}")
    if perm is not None and (perm.dim() != 1 or perm.dtype != torch.int32):
        raise ValueError(f"perm must be int32 [E], got {perm.dtype} "
                         f"{tuple(perm.shape)}")
    if scale is not None and (scale.dtype != torch.float32
                              or tuple(scale.shape) != vals.shape[:1]):
        raise ValueError(f"scale must be float32 [{vals.shape[0]}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")


def sorted_segment_sum_plain(vals: torch.Tensor, rowptr: torch.Tensor,
                             perm: Optional[torch.Tensor] = None,
                             scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``sorted_segment_sum`` by ``index_select``, the multiply and
    ``index_add_``, in float32 (float64 for float64 input)."""
    _check(vals, rowptr, perm, scale)
    m = rowptr.numel() - 1
    acc = _acc_dtype(vals.dtype)
    if perm is not None:
        vals = vals.index_select(0, perm)
        scale = None if scale is None else scale.index_select(0, perm)
    vals = vals.to(acc)
    if scale is not None:
        vals = vals * scale.to(acc)[:, None]
    keys = torch.repeat_interleave(
        torch.arange(m, device=vals.device), rowptr.diff().long(),
        output_size=vals.shape[0])
    out = torch.zeros(m, vals.shape[1], dtype=acc, device=vals.device)
    return out.index_add_(0, keys, vals)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum.argtypes = [i, p, p, p, p, p, i, i, p]
    lib.segment_sum.restype = i
    lib.segment_sum_rows.argtypes = [i, p, p, p, i, i, p]
    lib.segment_sum_rows.restype = i


def _launch(name: str, vals: torch.Tensor, rowptr: torch.Tensor,
            perm: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``segment_sum`` (with ``perm`` and ``scale``) or ``segment_sum_rows``
    on the card."""
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum takes float32 or bfloat16, got {vals.dtype}")
    if not all(t.is_contiguous() for t in (vals, rowptr, perm, scale)
               if t is not None):
        raise ValueError("segment_sum takes contiguous tensors")
    if vals.shape[0] >= 2**31 - 1:
        raise ValueError(f"{vals.shape[0]} values do not fit int32 offsets")
    m, h = rowptr.numel() - 1, vals.shape[1]
    out = torch.empty(m, h, dtype=torch.float32, device=vals.device)
    if m == 0 or h == 0:   # nothing to launch
        return out
    lib = cuda_build.load("segment_kernels", _declare)
    ptrs = [vals.data_ptr()]
    if name == "segment_sum":
        ptrs += [None if t is None else t.data_ptr() for t in (perm, scale)]
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(1 if vals.dtype == torch.bfloat16 else 0,
                                 *ptrs, rowptr.data_ptr(), out.data_ptr(), m,
                                 h, stream)
    cuda_build.check_launch(lib, err, name)
    cuda_build.LAUNCHES[name] += 1
    return out


def _on_card(*tensors: Optional[torch.Tensor]) -> bool:
    return cuda_build.on_card(*(t for t in tensors if t is not None))


def sorted_segment_sum(vals: torch.Tensor, rowptr: torch.Tensor,
                       perm: Optional[torch.Tensor] = None,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vals [E_v, h]``, ``rowptr [M + 1]`` int32, optional ``perm [E]``
    int32 (row indices into ``vals``, in range, in key order; without it
    ``vals`` is in key order) and ``scale [E_v]`` float32 (in ``vals``'
    order) -> ``[M, h]`` row sums of ``scale[perm[e]] * vals[perm[e]]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(vals, rowptr, perm, scale)
    if not _on_card(vals, rowptr, perm, scale):
        return sorted_segment_sum_plain(vals, rowptr, perm, scale)
    return _launch("segment_sum", vals, rowptr, perm, scale)


def sorted_segment_sum_rows(vals: torch.Tensor, rowptr: torch.Tensor,
                            perm: Optional[torch.Tensor] = None,
                            scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """:func:`sorted_segment_sum` by the earlier route: the scale as a
    float32 multiply and the gather by ``index_select``, then the
    kernel of values in key order (``segment_sum_rows_kernel``); the
    same bits. For timing and tests beside :func:`sorted_segment_sum`; no
    main path calls it."""
    _check(vals, rowptr, perm, scale)
    if not _on_card(vals, rowptr, perm, scale):
        return sorted_segment_sum_plain(vals, rowptr, perm, scale)
    if scale is not None:
        vals = vals.to(torch.float32) * scale[:, None]
    if perm is not None:
        vals = vals.index_select(0, perm)
    return _launch("segment_sum_rows", vals, rowptr)
