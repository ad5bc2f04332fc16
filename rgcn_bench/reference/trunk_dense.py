"""The dense trunk: two PyG ``RGCNConv`` layers with full relation weights
``[2R + 1, in, out]`` (``emb_dim -> hidden -> num_classes``, ReLU between,
mean aggregation), over the head's front output; and its cost counts.

Every ``trunk_<trunk>.py`` (a configuration's ``"trunk"``, ``dense`` where
it names none) gives the harness these five functions:

- ``init_params(config, gen, device)``: the trunk's initial parameters,
  leaves named ``rgcn<k>.<leaf>``, drawn from ``gen`` on ``device`` (a
  head's ``init_params`` calls it after its own draws);
- ``forward(x, params, edges, precision)``: the logits of every node;
  ``x`` is the head's front output, or ``None`` for a head with no front
  (a featureless model); ``edges`` the ``rgcn.Edges`` of the graph;
- ``conv_calls(config, s)``: ``(bytes, operations, unit)`` of each conv
  call of one epoch (the validation forward, the loss's forward, the
  backward), over the sizes ``s`` of ``cost.shapes``;
- ``flops(config, s)``: ``(forward, backward)`` model FLOPs of one pass;
- ``param_elements(config, s)``: the parameters' elements by leaf name.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from rgcn_bench import cost
from rgcn_bench.reference import rgcn


def _widths(config: Dict[str, Any]) -> Dict[str, Tuple[int, int]]:
    return {"rgcn1": (config["emb_dim"], config["hidden"]),
            "rgcn2": (config["hidden"], config["num_classes"])}


def conv(x: torch.Tensor, weight: torch.Tensor, root: torch.Tensor,
         bias: torch.Tensor, edges: rgcn.Edges,
         precision: str) -> torch.Tensor:
    """``x_i root + bias + sum_r mean_{j in N_r(i)} x_j weight[r]``."""
    msgs = [rgcn.product(x.index_select(0, edges.src[lo:hi]), weight[slot],
                         precision) * edges.norm[lo:hi, None].to(x.dtype)
            for slot, lo, hi in edges.slots]
    out = rgcn.product(x, root, precision) + bias
    return out.index_add(0, edges.dst, torch.cat(msgs))


def forward(x: torch.Tensor, params: Dict[str, torch.Tensor],
            edges: rgcn.Edges, precision: str) -> torch.Tensor:
    layer = lambda h, k: conv(h, params[f"{k}.weight"], params[f"{k}.root"],
                              params[f"{k}.bias"], edges, precision)
    return layer(torch.relu(layer(x, "rgcn1")), "rgcn2")


def init_params(config: Dict[str, Any], gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """The two layers as the reference initialises them: relation weights
    U(+-sqrt(6 / (in * out))), root U(+-sqrt(6 / (in + out))), zero bias;
    ``2R + 1`` relation slots."""
    slots = 2 * config["num_relations"] + 1
    out = {}
    for name, (i, o) in _widths(config).items():
        out[f"{name}.weight"] = rgcn.uniform(
            (slots, i, o), math.sqrt(6 / (i * o)), gen, device)
        out[f"{name}.root"] = rgcn.uniform((i, o), math.sqrt(6 / (i + o)),
                                           gen, device)
        out[f"{name}.bias"] = torch.zeros(o, device=device)
    return out


def conv_calls(config: Dict[str, Any], s: Dict[str, int]
               ) -> List[Tuple[int, int, str]]:
    """The span kernels' calls of one epoch: both layers forward twice
    (the validation forward and the loss's) and backward once."""
    dtype = config["compute_dtype"]
    widths = _widths(config).values()
    fwd = [cost.span_forward_cost(s, i, o, dtype) for i, o in widths]
    bwd = [cost.span_backward_cost(s, i, o, dtype) for i, o in widths]
    return fwd + fwd + bwd


def flops(config: Dict[str, Any], s: Dict[str, int]) -> Tuple[int, int]:
    """A layer's forward is its per-edge products and its root products;
    its backward their dx and dW, twice the forward."""
    n, e = s["nodes"], s["edges"]
    fwd = sum(2 * (e + n) * i * o for i, o in _widths(config).values())
    return fwd, 2 * fwd


def param_elements(config: Dict[str, Any], s: Dict[str, int]
                   ) -> Dict[str, int]:
    out = {}
    for name, (i, o) in _widths(config).items():
        out.update({f"{name}.weight": s["slots"] * i * o,
                    f"{name}.root": i * o, f"{name}.bias": o})
    return out
