"""The frozen cost copies against the port's ``span_kernels.forward_cost``
and ``backward_cost``: on a real plan at a tiny size, and from shapes alone
at the cells' sizes."""

import types

import numpy as np
import pytest
import torch

from rgcn_bench import cost, inputs, spec
from rgcn_bench.reference import trunk_dense
from rgcn_bench.tests.tiny import CELLS, tiny_cell
from scaling_rgcn_training_tpu_torch.ops import span_kernels
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges

WIDTHS = ((63, 16), (16, 11))


def _port(plan, d_in, d_out, dtype):
    x = torch.zeros(plan.num_src, d_in, dtype=dtype, device="meta")
    w = torch.zeros(plan.num_slots, d_in, d_out, dtype=dtype, device="meta")
    g = torch.zeros(plan.num_nodes, d_out, dtype=dtype, device="meta")
    return (span_kernels.forward_cost(x, w, plan),
            span_kernels.backward_cost(g, x, w, plan))


def _ours(s, d_in, d_out, dtype):
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return (cost.span_forward_cost(s, d_in, d_out, name),
            cost.span_backward_cost(s, d_in, d_out, name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_equal_on_a_real_plan(dtype):
    cell = tiny_cell("am_baseline_uniform", num_triples=9000)
    inp = inputs.make(cell, 5)
    src, dst, typ = inputs.program_edges(inp.triples)
    n = cell.config["num_entities"]
    slots = 2 * cell.config["num_relations"] + 1
    plan = build_rel_edges(src, dst, typ, n, slots).span
    s = cost.shapes(cell.config, typ)
    assert s["chunks"] == plan.num_chunks
    for d_in, d_out in WIDTHS:
        assert _ours(s, d_in, d_out, dtype) == _port(plan, d_in, d_out,
                                                     dtype)


def _shape_plan(s):
    """A plan of meta tensors with the sizes ``s``: what the cost
    functions read of a plan."""
    t = lambda k, dtype=torch.int32: torch.zeros(k, dtype=dtype,
                                                 device="meta")
    e, n, c = s["edges"], s["nodes"], s["chunks"]
    return types.SimpleNamespace(
        num_nodes=n, num_src=n, num_slots=s["slots"], rel_src=t(e),
        rel_dst=t(e), rel_norm=t(e, torch.float32), chunk_lo=t(c),
        chunk_hi=t(c), rel_chunk_ptr=t(s["slots"] + 1), fwd_rowptr=t(n + 1),
        fwd_pos=t(e), bwd_rowptr=t(n + 1), bwd_pos=t(e))


@pytest.mark.parametrize("name", CELLS)
def test_equal_at_the_cells_shapes(name):
    cell = spec.load_cell(name)
    inp = inputs.make(cell, 9)
    s = cost.shapes(cell.config, inputs.program_edges(inp.triples)[2])
    assert s["edges"] == 11_976_642 and s["slots"] == 267
    plan = _shape_plan(s)
    for d_in, d_out in WIDTHS:
        assert _ours(s, d_in, d_out, torch.float32) == _port(
            plan, d_in, d_out, torch.float32)


def test_epoch_counts():
    cell = spec.load_cell("am_baseline_uniform")
    s = {"nodes": 1_666_764, "edges": 11_976_642, "slots": 267,
         "chunks": 11_800}
    calls = trunk_dense.conv_calls(cell.config, s)
    assert len(calls) == 6
    flops = cost.model_flops(cell.config, s)
    # per-edge products: 2 forwards and a backward (dx, dW) of both layers
    edge = 2 * 11_976_642 * (63 * 16 + 16 * 11)
    assert 4 * edge < flops < 4 * edge * 1.2
    att = spec.load_cell("am_attention_uniform").config
    assert cost.model_flops(att, s) > flops
    assert cost.trainable_elements(cell.config, s) > 1_666_764 * 63
    assert cost.trainable_elements(att, s) < 1_000_000
    assert np.isclose(cost.adam_bound_s(cell.config, s),
                      28 * cost.trainable_elements(cell.config, s) / 3.35e12)
