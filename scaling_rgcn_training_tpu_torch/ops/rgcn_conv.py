"""The per-relation graph convolution (R-GCN message passing) in PyTorch.

The math of PyG ``RGCNConv`` as the reference uses it (model/layers.py:
15-16,21-23 with ``aggr='mean'``, ``root_weight=True``, ``bias=True``):

    out_i = x_i @ root + bias + sum_r ( mean_{j in N_r(i)} x_j ) @ weight[r]

Counterpart of the JAX package's ``ops/rgcn_conv.py``. The message-passing
sum runs through the span kernels (``ops/span_kernels.py``) in both
directions: ``relational_aggregate`` is a ``torch.autograd.Function``
whose backward is the backward kernel. Weights keep the JAX layout
``weight [R, in, out]``, ``root [in, out]``, ``bias [out]``, so the two
packages compare like with like.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from scaling_rgcn_training_tpu_torch.ops.span_kernels import (
    SpanPlan, plan_span, span_backward, span_forward)


def build_rel_edges(edge_src: np.ndarray, edge_dst: np.ndarray,
                    edge_type: np.ndarray, num_nodes: int, num_slots: int,
                    device="cpu") -> SpanPlan:
    """Host-side edge build, once per graph: the mean coefficient
    ``norm_e = 1 / deg_r(dst_e)`` (in-degree of ``dst_e`` over edges of
    ``e``'s relation) and the kernels' edge plan."""
    src = np.asarray(edge_src, np.int32)
    dst = np.asarray(edge_dst, np.int32)
    typ = np.asarray(edge_type, np.int32)
    keys = typ.astype(np.int64) * num_nodes + dst.astype(np.int64)
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    norm = (1.0 / counts[inv.reshape(-1)]).astype(np.float32)
    return plan_span(src, dst, typ, norm, num_nodes, num_slots, device=device)


class RGCNLayer(nn.Module):
    """One R-GCN layer's parameters, optionally decomposed.

    - full:       ``weight [R, in, out]``, ``comp`` None
    - basis:      ``weight [B, in, out]`` (bases), ``comp [R, B]``
    - block-diag: ``weight [R, nb, in/nb, out/nb]``, ``comp`` None
    ``root [in, out]`` and ``bias [out]`` are always dense.
    """

    def __init__(self, weight: torch.Tensor, root: torch.Tensor,
                 bias: torch.Tensor, comp: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.root = nn.Parameter(root)
        self.bias = nn.Parameter(bias)
        self.comp = None if comp is None else nn.Parameter(comp)


def materialize_weight(layer: RGCNLayer) -> torch.Tensor:
    """-> dense ``[R, in, out]`` relation weights from any decomposition."""
    w = layer.weight
    if layer.comp is not None:  # basis decomposition
        return torch.einsum("rb,bio->rio", layer.comp, w)
    if w.dim() == 4:  # block-diagonal [R, nb, i/nb, o/nb] -> [R, in, out]
        r, nb, bi, bo = w.shape
        eye = torch.eye(nb, dtype=w.dtype, device=w.device)
        return torch.einsum("rbio,bc->rbico", w, eye).reshape(r, nb * bi, nb * bo)
    return w


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def init_rgcn_layer(gen: torch.Generator, num_slots: int, in_dim: int,
                    out_dim: int, num_bases: Optional[int] = None,
                    num_blocks: Optional[int] = None,
                    device="cpu") -> RGCNLayer:
    """Initialization matching the reference's distributions.

    - relation weights: torch ``kaiming_uniform_(mode='fan_in')`` on the
      ``[R, in, out]`` tensor (model/layers.py:17-18): bound
      ``sqrt(6 / (in * out))`` (torch's fan_in of a 3-D tensor is
      ``size(1) * prod(size()[2:])``);
    - root: PyG glorot, bound ``sqrt(6 / (in + out))``;
    - bias: zeros (PyG default).
    """
    comp = None
    if num_blocks is not None:
        if in_dim % num_blocks or out_dim % num_blocks:
            raise ValueError("block-diagonal decomposition needs in/out "
                             "divisible by num_blocks")
        w_shape = (num_slots, num_blocks, in_dim // num_blocks,
                   out_dim // num_blocks)
        fan = w_shape[1] * w_shape[2] * w_shape[3]
    elif num_bases is not None:
        w_shape = (num_bases, in_dim, out_dim)
        fan = in_dim * out_dim
        comp = _uniform(gen, (num_slots, num_bases),
                        float(np.sqrt(6.0 / (num_slots + num_bases))))
    else:
        w_shape = (num_slots, in_dim, out_dim)
        fan = in_dim * out_dim
    weight = _uniform(gen, w_shape, float(np.sqrt(6.0 / fan)))
    root = _uniform(gen, (in_dim, out_dim), float(np.sqrt(6.0 / (in_dim + out_dim))))
    layer = RGCNLayer(weight, root, torch.zeros(out_dim), comp)
    return layer.to(device)


class _RelationalAggregate(torch.autograd.Function):
    """``sum_e norm_e * (x[src_e] @ w[rel_e])`` onto dst, with the backward
    kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.save_for_backward(x, w)
        ctx.plan = plan
        return span_forward(x, w, plan)

    @staticmethod
    def backward(ctx, g_out):
        x, w = ctx.saved_tensors
        # cast before the gather: [N, d_out] once, not [E, d_out]
        dx, dw = span_backward(g_out.to(w.dtype).contiguous(), x, w, ctx.plan)
        return dx.to(x.dtype), dw.to(w.dtype), None


def relational_aggregate(x: torch.Tensor, w: torch.Tensor,
                         plan: SpanPlan) -> torch.Tensor:
    """``[N, d_in] -> [N, d_out]`` mean-normalized relational sum; float32
    for float32 or bfloat16 inputs."""
    return _RelationalAggregate.apply(x.contiguous(), w.contiguous(), plan)


def rgcn_conv(x: torch.Tensor, edges: SpanPlan, layer: RGCNLayer,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply one R-GCN layer: ``[N, in] -> [N, out]``.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): the aggregation's gathers
    and products read ``x`` and the relation weights in that dtype, while
    every sum and the output stay float32; the root and bias term stays in
    the parameters' float32.
    """
    w = materialize_weight(layer)
    if compute_dtype is not None:
        agg = relational_aggregate(x.to(compute_dtype), w.to(compute_dtype),
                                   edges)
    else:
        agg = relational_aggregate(x, w, edges)
    return agg + x @ layer.root + layer.bias
