"""SDDMM (sampled dense-dense matmul) over graph edges and the relational
attention aggregation built on it.

Counterpart of the JAX package's ``ops/sddmm.py``:

    sddmm:       s_e = <x[src_e], y[dst_e]>                      [E]
    sddmm_rel:   s_e = <x[src_e] @ W[rel_e], y[dst_e]>           [E]

``segment_softmax`` turns scores into per-destination weights, and
``attention_aggregate`` composes the pipeline exposed as
``rgcn_conv(..., aggr="attention")``:

    m_e     = x[src_e] @ W[rel_e]                   (per-edge message)
    s_e     = <m_e, x[dst_e] @ root> / sqrt(d_out)  (SDDMM score)
    alpha_e = softmax over {e : dst_e = i} of s_e   (segment softmax)
    out_i   = sum_e alpha_e * m_e                   (weighted sum)

The per-edge transform is the grouped matmul with the caller's backend
(with ``"pallas"``, the grouped-matmul kernels in both directions). The
segment max and sums are PyTorch's ``scatter_reduce`` and ``index_add``,
as the JAX package leaves them to XLA. Autograd differentiates the whole.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Optional

import torch

from scaling_rgcn_training_tpu_torch.ops.grouped_matmul import grouped_matmul

if TYPE_CHECKING:
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RelEdges


def sddmm(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
          dst: torch.Tensor) -> torch.Tensor:
    """Per-edge inner products ``<x[src_e], y[dst_e]>`` -> float32 [E]."""
    return (x.index_select(0, src).float()
            * y.index_select(0, dst).float()).sum(-1)


def sddmm_rel(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              edges: "RelEdges", backend: Optional[str] = None) -> torch.Tensor:
    """Relational SDDMM ``<x[src_e] @ W[rel_e], y[dst_e]>`` -> float32 [E];
    ``w [num_slots, d_x, d_y]``."""
    z = grouped_matmul(x.index_select(0, edges.src), w, edges.group_sizes,
                       backend=backend, static_offsets=edges.group_offsets)
    return (z.float() * y.index_select(0, edges.dst).float()).sum(-1)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of ``scores`` within each segment (e.g. per dst node).

    ``mask`` (per edge, e.g. ``edges.norm``): rows with ``mask <= 0`` get
    weight 0. Stable by subtracting each segment's max; the softmax does
    not change with that shift, so the max carries no gradient.
    """
    if mask is not None:
        scores = torch.where(mask > 0, scores, float("-inf"))
    # scatter_reduce takes int64 indices only
    seg_max = torch.full((num_segments,), float("-inf"), dtype=scores.dtype,
                         device=scores.device).scatter_reduce(
        0, segment_ids.long(), scores.detach(), "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = scores - seg_max.index_select(0, segment_ids)
    expd = torch.where(torch.isfinite(shifted), torch.exp(shifted), 0.0)
    denom = torch.zeros(num_segments, dtype=expd.dtype,
                        device=expd.device).index_add(0, segment_ids, expd)
    denom = torch.where(denom > 0, denom, 1.0)
    return expd / denom.index_select(0, segment_ids)


def attention_aggregate(x: torch.Tensor, w: torch.Tensor, root: torch.Tensor,
                        edges: "RelEdges",
                        backend: Optional[str] = None) -> torch.Tensor:
    """Relational attention over each node's incoming edges -> float32
    ``[N, d_out]``; edges with ``norm <= 0`` are masked out."""
    n, d_out = edges.num_nodes, w.shape[2]
    msg = grouped_matmul(x.index_select(0, edges.src), w, edges.group_sizes,
                         backend=backend, static_offsets=edges.group_offsets)
    keys = x @ root                                              # [N, d_out]
    scores = (msg.float() * keys.index_select(0, edges.dst).float()
              ).sum(-1) * (1.0 / math.sqrt(d_out))
    alpha = segment_softmax(scores, edges.dst, n, mask=edges.norm)
    return torch.zeros(n, d_out, dtype=torch.float32,
                       device=x.device).index_add(
        0, edges.dst, msg.float() * alpha[:, None])
