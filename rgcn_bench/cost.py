"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's published peaks, the bytes and operations of
the conv's span kernels (copies of ``span_kernels.forward_cost`` and
``backward_cost`` as the port counts them, from shapes alone), the model's
FLOPs an epoch and Adam's bytes. The trunk's conv calls, FLOPs and
parameters are counted in its reference file
(``reference/trunk_<trunk>.py`` ``conv_calls``, ``flops``,
``param_elements``), each head's FLOPs and parameters in its own
(``reference/head_<head>.py`` ``flops``, ``param_elements``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from rgcn_bench.reference import rgcn

# NVIDIA H100 SXM, data sheet, dense: HBM bytes/s and FLOP/s by arithmetic
PEAKS = {"hbm_bytes_per_s": 3.35e12, "float32": 67e12, "tf32": 495e12,
         "bfloat16": 989e12}
# edges of one relation per dW chunk of the span plan
DW_CHUNK = 1024
_ITEM = {"float32": 4, "bfloat16": 2}


def shapes(config: Dict[str, Any], edge_type: np.ndarray) -> Dict[str, int]:
    """The sizes the cost functions take, from the configuration and the
    edges' relation slots as the program receives them."""
    slots = 2 * int(config["num_relations"]) + 1
    per_slot = np.bincount(edge_type, minlength=slots)
    return {"nodes": int(config["num_entities"]), "edges": int(edge_type.size),
            "slots": slots, "chunks": int((-(-per_slot // DW_CHUNK)).sum())}


def _bound(n_bytes: float, ops: float, unit: str) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS[unit])


def span_forward_cost(s: Dict[str, int], d_in: int, d_out: int,
                      dtype: str = "float32") -> Tuple[int, int, str]:
    """``(bytes, operations, unit)`` of one ``span_forward`` call: x, w and
    the plan arrays its kernels read (relation-ordered src and norm, the
    chunk bounds, the relation chunk pointer, the forward row pointer and
    positions), each once, and the float32 output once; ``2 E d_in d_out``
    products, three times over for float32 (3xTF32)."""
    n, e, slots, c = s["nodes"], s["edges"], s["slots"], s["chunks"]
    item = _ITEM[dtype]
    n_bytes = (n * d_in * item + slots * d_in * d_out * item
               + 4 * (3 * e + 2 * c + (slots + 1) + (n + 1)) + 4 * n * d_out)
    ops = 2 * e * d_in * d_out
    return (n_bytes, ops, "bfloat16") if dtype == "bfloat16" else \
        (n_bytes, 3 * ops, "tf32")


def span_backward_cost(s: Dict[str, int], d_in: int, d_out: int,
                       dtype: str = "float32") -> Tuple[int, int, str]:
    """``(bytes, operations, unit)`` of one ``span_backward`` call: g_out,
    x, w and the plan arrays (relation-ordered src, dst and norm, chunk
    bounds, relation chunk pointer, the src row pointer and positions),
    each once, and the float32 dx and dW once; ``2 E d_in d_out`` products
    for each half, three times over for float32."""
    n, e, slots, c = s["nodes"], s["edges"], s["slots"], s["chunks"]
    item = _ITEM[dtype]
    n_bytes = ((n * d_out + n * d_in + slots * d_in * d_out) * item
               + 4 * (4 * e + 2 * c + (slots + 1) + (n + 1))
               + 4 * (n * d_in + slots * d_in * d_out))
    ops = 4 * e * d_in * d_out
    return (n_bytes, ops, "bfloat16") if dtype == "bfloat16" else \
        (n_bytes, 3 * ops, "tf32")


def conv_bound_s(config: Dict[str, Any], s: Dict[str, int]) -> float:
    """Least seconds an epoch's conv calls (the trunk's ``conv_calls``)
    can take on the card."""
    calls = rgcn.trunk_module(config).conv_calls(config, s)
    return sum(_bound(*call) for call in calls)


def model_flops(config: Dict[str, Any], s: Dict[str, int]) -> int:
    """Model FLOPs of one epoch: the validation forward, the loss's
    forward and the backward, of the trunk and the head (each module's
    ``flops``)."""
    trunk_fwd, trunk_bwd = rgcn.trunk_module(config).flops(config, s)
    head_fwd, head_bwd = rgcn.head_module(config).flops(config, s["nodes"])
    return 2 * (trunk_fwd + head_fwd) + trunk_bwd + head_bwd


def trainable_elements(config: Dict[str, Any], s: Dict[str, int]) -> int:
    """Parameters Adam updates: the trunk's and the head's (each module's
    ``param_elements``, the head's by top-level name) that are not
    frozen."""
    frozen = set(config.get("frozen", ()))
    trunk = rgcn.trunk_module(config).param_elements(config, s)
    head = rgcn.head_module(config).param_elements(config, s["nodes"])
    return sum(k for name, k in (*trunk.items(), *head.items())
               if name not in frozen)


def adam_bound_s(config: Dict[str, Any], s: Dict[str, int]) -> float:
    """Least seconds of one Adam step: each float32 parameter, gradient
    and both moments read once, the parameter and moments written once."""
    return 28 * trainable_elements(config, s) / PEAKS["hbm_bytes_per_s"]
