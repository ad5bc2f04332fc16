"""Sorted-key segment sum: the CUDA kernel's wrapper, its launch counter and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/segment_kernels.py``
(``sorted_segment_sum_pallas`` over ``_seg_kernel``): for values whose keys
are sorted ascending, ``out[k] = sum_{e: keys_e = k} vals_e``. The TPU
version plans buckets of output rows and chunks of values and reduces
one-hot tiles on the MXU; the port's plan is a CSR row pointer ``[M + 1]``
over the sorted keys (:func:`segment_rowptr`), and the kernel
(``csrc/segment_kernels.cu``) gives whole output rows to groups of lanes.

``vals`` is float32 or bfloat16 (float64 on the CPU, for gradcheck); sums
and the result are float32 for both (float64 for float64), as the TPU
version returns float32 for low-precision input.
"""

from __future__ import annotations

import ctypes

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


def _check(vals: torch.Tensor, rowptr: torch.Tensor) -> None:
    if vals.dim() != 2 or rowptr.dim() != 1 or rowptr.numel() < 1:
        raise ValueError(f"vals {tuple(vals.shape)} and rowptr "
                         f"{tuple(rowptr.shape)} are not [E, h] and [M + 1]")
    if rowptr.dtype != torch.int32:
        raise TypeError(f"rowptr must be int32, got {rowptr.dtype}")


def sorted_segment_sum_plain(vals: torch.Tensor,
                             rowptr: torch.Tensor) -> torch.Tensor:
    """``sorted_segment_sum`` with ``index_add_`` in float32 (float64 for
    float64 input)."""
    _check(vals, rowptr)
    m = rowptr.numel() - 1
    acc = _acc_dtype(vals.dtype)
    keys = torch.repeat_interleave(
        torch.arange(m, device=vals.device), rowptr.diff().long(),
        output_size=vals.shape[0])
    out = torch.zeros(m, vals.shape[1], dtype=acc, device=vals.device)
    return out.index_add_(0, keys, vals.to(acc))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum.argtypes = [i, p, p, p, i, i, p]
    lib.segment_sum.restype = i


def sorted_segment_sum(vals: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """``vals [E, h]`` in key order, ``rowptr [M + 1]`` int32 ->
    ``[M, h]`` row sums. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(vals, rowptr)
    if not cuda_build.on_card(vals, rowptr):
        return sorted_segment_sum_plain(vals, rowptr)
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum takes float32 or bfloat16, got {vals.dtype}")
    if not (vals.is_contiguous() and rowptr.is_contiguous()):
        raise ValueError("segment_sum takes contiguous tensors")
    if vals.shape[0] >= 2**31 - 1:
        raise ValueError(f"{vals.shape[0]} values do not fit int32 offsets")
    m, h = rowptr.numel() - 1, vals.shape[1]
    out = torch.empty(m, h, dtype=torch.float32, device=vals.device)
    if m == 0 or h == 0:   # nothing to launch
        return out
    lib = cuda_build.load("segment_kernels", _declare)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segment_sum(1 if vals.dtype == torch.bfloat16 else 0,
                              vals.data_ptr(), rowptr.data_ptr(),
                              out.data_ptr(), m, h, stream)
    cuda_build.check_launch(lib, err, "segment_sum")
    cuda_build.LAUNCHES["segment_sum"] += 1
    return out
