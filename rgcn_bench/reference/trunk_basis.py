"""The basis trunk of the R-GCN paper's entity classifier (Schlichtkrull et
al. 2018 §5.1; PyG ``RGCNConv`` with ``num_bases``), behind a head with no
front (``x`` None): layer 1 reads the node id, its relation weights
``W_r[i] = sum_b comp[r, b] bases[i, b]`` a row a node out of bases ``[N,
B, hidden]`` (PyG's ``weight[b, i]`` is ``bases[i, b]``: the port's basis
kernels read a node's ``B x hidden`` block whole), with ``root [N,
hidden]`` the node's own row; ReLU; layer 2 ``hidden -> num_classes`` on
PyG's bases ``weight [B, hidden, num_classes]``; mean aggregation. The
trunk's five functions as ``trunk_dense.py`` describes them, and
``basis_calls``: the least bytes and operations of the basis kernels'
calls of an epoch.

Layer 1 runs over blocks of ``BLOCK`` relation-ordered edges, each under
``torch.utils.checkpoint`` (recomputed in the backward), so that no
``[E, B, hidden]`` gather is ever whole: at AM a block's gather is 1.7 GB
in float64. Its contraction ``sum_b (norm_e comp[rel_e, b]) bases[src_e,
b]`` and layer 2's ``comp @ weight`` go through ``rgcn.product``, so
the control computes them in TF32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rgcn_bench import cost
from rgcn_bench.reference import rgcn, trunk_dense

# relation-ordered edges a block of layer 1 takes
BLOCK = 1 << 19


def _shapes(config: Dict[str, Any], n: int, slots: int
            ) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Each leaf's shape and glorot fans (``in + out``; none for a bias)."""
    b, h, c = config["num_bases"], config["hidden"], config["num_classes"]
    return {"rgcn1.bases": ((n, b, h), n + h),
            "rgcn1.comp": ((slots, b), slots + b),
            "rgcn1.root": ((n, h), n + h),
            "rgcn1.bias": ((h,), 0),
            "rgcn2.weight": ((b, h, c), h + c),
            "rgcn2.comp": ((slots, b), slots + b),
            "rgcn2.root": ((h, c), h + c),
            "rgcn2.bias": ((c,), 0)}


def init_params(config: Dict[str, Any], gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """PyG ``RGCNConv.reset_parameters``, layer by layer: bases, comp and
    root glorot (U(+-sqrt(6 / (fan_in + fan_out))); the bases' fans are
    ``in`` and ``out``), bias zeros."""
    slots = 2 * config["num_relations"] + 1
    return {k: torch.zeros(shape, device=device) if not fans
            else rgcn.uniform(shape, math.sqrt(6 / fans), gen, device)
            for k, (shape, fans) in _shapes(
                config, config["num_entities"], slots).items()}


def _messages(bases, comp, src, rel, norm, precision) -> torch.Tensor:
    """``[k, hidden]``: each edge's ``sum_b norm_e comp[rel_e, b]
    bases[src_e, b]``."""
    coef = comp.index_select(0, rel) * norm[:, None].to(comp.dtype)
    rows = bases.index_select(0, src)                         # [k, B, h]
    return rgcn.product(coef[:, None, :], rows, precision)[:, 0]


class _ReleaseCache(torch.autograd.Function):
    """The identity; its backward, the last of layer 1's (every block's
    gradient of the bases summed), hands the allocator's unused memory back
    to the card, so that Adam's float64 temporaries find room."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            torch.cuda.empty_cache()
        return g


def layer1(params: Dict[str, torch.Tensor], edges: rgcn.Edges,
           precision: str, block: int = BLOCK) -> torch.Tensor:
    """``root + bias + sum_r mean_{j in N_r(i)} W_r[j]``, over blocks of
    ``block`` edges, each recomputed in the backward."""
    bases = _ReleaseCache.apply(params["rgcn1.bases"])
    comp = params["rgcn1.comp"]
    rel = torch.cat([torch.full((hi - lo,), slot, dtype=torch.int64,
                                device=edges.src.device)
                     for slot, lo, hi in edges.slots])
    out = params["rgcn1.root"] + params["rgcn1.bias"]
    for lo in range(0, edges.src.shape[0], block):
        sl = slice(lo, lo + block)
        msgs = checkpoint(_messages, bases, comp, edges.src[sl], rel[sl],
                          edges.norm[sl], precision, use_reentrant=False)
        out = out.index_add(0, edges.dst[sl], msgs)
    return out


def forward(x, params: Dict[str, torch.Tensor], edges: rgcn.Edges,
            precision: str) -> torch.Tensor:
    if x is not None:
        raise ValueError("the basis trunk reads the node id: x must be None")
    h = torch.relu(layer1(params, edges, precision))
    bases, comp = params["rgcn2.weight"], params["rgcn2.comp"]
    b, i, o = bases.shape
    weight = rgcn.product(comp, bases.reshape(b, i * o),
                          precision).reshape(-1, i, o)
    return trunk_dense.conv(h, weight, params["rgcn2.root"],
                            params["rgcn2.bias"], edges, precision)


def conv_calls(config: Dict[str, Any], s: Dict[str, int]
               ) -> List[Tuple[int, int, str]]:
    """Layer 2's span kernel calls of one epoch (forward twice, backward
    once); layer 1 runs the basis kernels (``basis_calls``)."""
    h, c, dtype = config["hidden"], config["num_classes"], \
        config["compute_dtype"]
    fwd = cost.span_forward_cost(s, h, c, dtype)
    return [fwd, fwd, cost.span_backward_cost(s, h, c, dtype)]


def basis_calls(config: Dict[str, Any], s: Dict[str, int]
                ) -> List[Tuple[int, int, str]]:
    """``(bytes, operations, unit)`` of the basis layer's calls of one
    epoch (the validation forward, the loss's forward, the backward), the
    least any implementation moves in float32: a forward reads the bases
    once, ``comp``, 12 B an edge (its src, relation and coefficient) and
    writes the ``[N, hidden]`` output; a backward reads the bases and
    writes their gradient, reads and writes ``comp``'s, reads the
    ``[N, hidden]`` gradient and 12 B an edge; ``2 B hidden`` FLOP an edge
    forward, twice that backward, on the CUDA cores."""
    n, e, slots = s["nodes"], s["edges"], s["slots"]
    b, h = config["num_bases"], config["hidden"]
    fwd = (4 * (n * b * h + slots * b + n * h) + 12 * e,
           2 * e * b * h, "float32")
    bwd = (4 * (2 * n * b * h + 2 * slots * b + n * h) + 12 * e,
           4 * e * b * h, "float32")
    return [fwd, fwd, bwd]


def flops(config: Dict[str, Any], s: Dict[str, int]) -> Tuple[int, int]:
    """Layer 1's per-edge contraction (``2 B hidden`` an edge; its root is
    a row read, no product), layer 2's per-edge and root products; the
    backward twice the forward."""
    n, e = s["nodes"], s["edges"]
    b, h, c = config["num_bases"], config["hidden"], config["num_classes"]
    fwd = 2 * e * b * h + 2 * (e + n) * h * c
    return fwd, 2 * fwd


def param_elements(config: Dict[str, Any], s: Dict[str, int]
                   ) -> Dict[str, int]:
    return {k: math.prod(shape) for k, (shape, _) in
            _shapes(config, s["nodes"], s["slots"]).items()}
