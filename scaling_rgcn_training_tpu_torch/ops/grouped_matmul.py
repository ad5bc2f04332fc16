"""Grouped (ragged) matrix multiply: the per-edge relational transform.

Counterpart of the JAX package's ``ops/grouped_matmul.py``. For rows of
``lhs [M, K]`` cut into ``G`` consecutive groups of ``group_sizes[g]`` rows
and ``rhs [G, K, N]``:

    out[rows of group g] = lhs[rows of group g] @ rhs[g]

``out`` has ``lhs``'s dtype; products are summed in float32. Backends:

- ``"ragged"`` (the default, as in the JAX package, whose ``ragged_dot`` is
  XLA's library grouped matmul): one ``torch.matmul`` per group over the
  host-known group offsets;
- ``"gather"``: the plain version, a per-row weight gather and a batched
  product (``ops/grouped_kernels.py`` ``gmm_plain``);
- ``"pallas"``: the hand-written kernels, through the autograd Function
  ``GroupedMatmul`` (CUDA on the card; their plain versions on the CPU).
  The name is the JAX package's, kept so the CLI flags are the same.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from scaling_rgcn_training_tpu_torch.ops.grouped_kernels import (
    GroupedMatmul, gmm_plain)

BACKENDS = ("ragged", "gather", "pallas")
_DEFAULT_BACKEND = "ragged"


def set_default_backend(name: str) -> None:
    global _DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown grouped_matmul backend: {name}")
    _DEFAULT_BACKEND = name


def _ragged(lhs: torch.Tensor, rhs: torch.Tensor,
            offsets: Sequence[int]) -> torch.Tensor:
    parts = [lhs[a:b] @ rhs[g]
             for g, (a, b) in enumerate(zip(offsets[:-1], offsets[1:]))]
    return torch.cat(parts) if parts else lhs.new_zeros(0, rhs.shape[2])


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, backend: Optional[str] = None,
                   static_offsets: Optional[Sequence[int]] = None
                   ) -> torch.Tensor:
    """``out[i] = lhs[i] @ rhs[group_of(i)]`` with consecutive groups.

    ``static_offsets``: the host-known group offsets ``[G + 1]`` (e.g.
    ``RelEdges.group_offsets``); the ``"ragged"`` loop needs them and reads
    them from ``group_sizes`` (a device sync) when they are not given.
    """
    backend = backend or _DEFAULT_BACKEND
    if backend == "ragged":
        if static_offsets is None:
            static_offsets = [0] + torch.cumsum(group_sizes, 0).tolist()
        if static_offsets[-1] != lhs.shape[0]:
            raise ValueError(f"groups hold {static_offsets[-1]} rows, lhs "
                             f"has {lhs.shape[0]}")
        return _ragged(lhs, rhs, static_offsets)
    if backend == "gather":
        return gmm_plain(lhs, rhs, group_sizes)
    if backend == "pallas":
        return GroupedMatmul.apply(lhs, rhs, group_sizes)
    raise ValueError(f"unknown grouped_matmul backend: {backend}")
