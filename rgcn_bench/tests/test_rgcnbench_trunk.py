"""The trunk as a configuration's plug-in (``reference/trunk_<trunk>.py``):

- the dense trunk gives what it gave before it became one: the float64
  reference's losses, validation metrics and gradient norms over three
  steps at the tiny size, and the cost entry points at the tiny size and
  at AM's full size, against ``golden_dense.json`` (recorded while the
  dense trunk still lived in ``rgcn.py`` and ``cost.py``);
- a stand-in trunk defined here (featureless, basis-decomposed, with no
  ``rgcn1.weight``), behind a stand-in head with no front and a
  configuration with no ``emb_dim``, runs through ``rgcn.fit``,
  ``compare.both`` and the cost entry points, which read its counts.
"""

import json
import math
import sys
import types
from pathlib import Path

import pytest
import torch

from rgcn_bench import compare, cost, inputs, spec
from rgcn_bench.reference import rgcn, trunk_dense
from rgcn_bench.tests.tiny import CELLS, tiny_cell

GOLDEN = json.loads((Path(__file__).parent / "golden_dense.json").read_text())
# float64 sums whose order follows the CPU's thread count part in the last
# bits (two recordings differed by up to 7e-16)
REL = 1e-12


def _fit_recording_grads(config, inp, steps, monkeypatch):
    """The reference's fit from the run's initial parameters, and each
    step's gradient norm by trainable leaf (before the L2 term)."""
    params0 = inputs.params(config, inp, "cpu")
    edges = rgcn.build_edges(*inp.triples, config["num_entities"], "cpu")
    frozen = set(config.get("frozen", ()))
    names = [k for k in params0 if k not in frozen]
    norms = []
    grad = torch.autograd.grad

    def recording(outputs, leaves, *args, **kwargs):
        out = grad(outputs, leaves, *args, **kwargs)
        norms.append({k: float(torch.linalg.vector_norm(g))
                      for k, g in zip(names, out)})
        return out

    monkeypatch.setattr(torch.autograd, "grad", recording)
    readings = rgcn.fit(config, edges, inp.labels, params0, steps,
                        inputs.dropout_masks(config, inp, "cpu"))
    return readings, norms


@pytest.mark.parametrize("name", CELLS)
def test_dense_reference_as_recorded(name, monkeypatch):
    want = GOLDEN[name]
    cell = tiny_cell(name)
    inp = inputs.make(cell, GOLDEN["seed"])
    readings, norms = _fit_recording_grads(cell.config, inp, GOLDEN["steps"],
                                           monkeypatch)
    assert readings.losses == pytest.approx(want["losses"], rel=REL)
    for got, rec in zip(readings.val, want["val"]):
        assert list(got) == pytest.approx(rec, rel=REL)
    assert len(norms) == len(want["grad_norms"])
    for got, rec in zip(norms, want["grad_norms"]):
        assert list(got) == list(rec)
        assert got == pytest.approx(rec, rel=REL)


ENTRY_POINTS = ("conv_bound_s", "model_flops", "trainable_elements",
                "adam_bound_s")


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("name", CELLS)
def test_dense_costs_as_recorded(name, size):
    want = GOLDEN[name][f"cost_{size}"]
    tiny = size == "tiny"
    config = (tiny_cell(name) if tiny else spec.load_cell(name)).config
    s = GOLDEN[name]["tiny_shapes"] if tiny else GOLDEN["full_shapes"]
    got = {k: getattr(cost, k)(config, s) for k in ENTRY_POINTS}
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


# -- a stand-in trunk: featureless, basis-decomposed ------------------------

TRUNK, HEAD = "basis_stand_in", "featureless_stand_in"
BASES = 3


def _stand_in_init(config, gen, device):
    """Layer 1 over the node id (``W_r = sum_b comp[r, b] V_b``, bases
    ``[B, N, hidden]``, root ``[N, hidden]``), layer 2 basis-decomposed
    ``[B, hidden, classes]``."""
    slots = 2 * config["num_relations"] + 1
    n, h, c = config["num_entities"], config["hidden"], config["num_classes"]
    u = lambda shape: rgcn.uniform(shape, 0.5, gen, device)
    zero = lambda k: torch.zeros(k, device=device)
    return {"rgcn1.bases": u((BASES, n, h)), "rgcn1.comp": u((slots, BASES)),
            "rgcn1.root": u((n, h)), "rgcn1.bias": zero(h),
            "rgcn2.bases": u((BASES, h, c)), "rgcn2.comp": u((slots, BASES)),
            "rgcn2.root": u((h, c)), "rgcn2.bias": zero(c)}


def _stand_in_forward(x, params, edges, precision):
    assert x is None
    bases, comp = params["rgcn1.bases"], params["rgcn1.comp"]
    msgs = [torch.einsum("b,beh->eh", comp[slot], bases[:, edges.src[lo:hi]])
            * edges.norm[lo:hi, None].to(bases.dtype)
            for slot, lo, hi in edges.slots]
    h = (params["rgcn1.root"] + params["rgcn1.bias"]).index_add(
        0, edges.dst, torch.cat(msgs))
    weight = torch.einsum("sb,bio->sio", params["rgcn2.comp"],
                          params["rgcn2.bases"])
    return trunk_dense.conv(torch.relu(h), weight, params["rgcn2.root"],
                            params["rgcn2.bias"], edges, precision)


def _stand_in_conv_calls(config, s):
    """Each pass gathers every edge's B x hidden basis rows in float32."""
    e, h = s["edges"], config["hidden"]
    call = (4 * e * BASES * h, 2 * e * BASES * h, "float32")
    return [call, call, call]


def _stand_in_flops(config, s):
    e, h = s["edges"], config["hidden"]
    return 2 * e * BASES * h, 4 * e * BASES * h


def _stand_in_param_elements(config, s):
    n, h, c = s["nodes"], config["hidden"], config["num_classes"]
    return {"rgcn1.bases": BASES * n * h, "rgcn1.comp": s["slots"] * BASES,
            "rgcn1.root": n * h, "rgcn1.bias": h,
            "rgcn2.bases": BASES * h * c, "rgcn2.comp": s["slots"] * BASES,
            "rgcn2.root": h * c, "rgcn2.bias": c}


def _stand_in_head_init(config, gen, device):
    return rgcn.trunk_module(config).init_params(config, gen, device)


@pytest.fixture
def stand_in(monkeypatch):
    """The stand-in trunk and head in ``sys.modules`` under the names the
    harness imports, and a tiny configuration that names them."""
    trunk = types.ModuleType(f"rgcn_bench.reference.trunk_{TRUNK}")
    trunk.init_params = _stand_in_init
    trunk.forward = _stand_in_forward
    trunk.conv_calls = _stand_in_conv_calls
    trunk.flops = _stand_in_flops
    trunk.param_elements = _stand_in_param_elements
    head = types.ModuleType(f"rgcn_bench.reference.head_{HEAD}")
    head.SPLITS = {}
    head.init_params = _stand_in_head_init
    head.front = lambda params, config, precision, dropout_masks=None: None
    head.flops = lambda config, n: (0, 0)
    head.param_elements = lambda config, n: {}
    monkeypatch.setitem(sys.modules, trunk.__name__, trunk)
    monkeypatch.setitem(sys.modules, head.__name__, head)
    cell = tiny_cell("am_baseline_uniform", head=HEAD, trunk=TRUNK, hidden=6)
    del cell.config["emb_dim"]
    return cell


def test_stand_in_trunk_fits_and_compares(stand_in):
    config = stand_in.config
    inp = inputs.make(stand_in, 2**33 + 7)
    params0 = inputs.params(config, inp, "cpu")
    assert "rgcn1.weight" not in params0 and "rgcn1.bases" in params0
    edges = rgcn.build_edges(*inp.triples, config["num_entities"], "cpu")
    fit = lambda state=None: rgcn.fit(config, edges, inp.labels, params0, 1,
                                      state=state)
    start = fit()
    assert set(start.grad1) == set(params0)
    assert all(math.isfinite(x) for x in start.losses)
    b1, b2 = config["adam_betas"]
    g = start.grad1
    state = rgcn.State(1, start.params1,
                       {k: (1 - b1) * v for k, v in g.items()},
                       {k: (1 - b2) * v * v for k, v in g.items()})
    replay = fit(state)
    assert replay.losses[0] != start.losses[0]
    values = compare.both(config, (start, start), (replay, replay), params0,
                          state, inp.labels["y_val"])
    assert set(values) == set(compare.NUMBERS)
    assert all(v == 0 for v in values.values()), values


def test_stand_in_trunk_costs(stand_in):
    config = stand_in.config
    s = {"nodes": 1_666_764, "edges": 11_976_642, "slots": 267,
         "chunks": 11_824}
    e, n, h, c = s["edges"], s["nodes"], config["hidden"], \
        config["num_classes"]
    # bytes bound each call: 4 B x 3 bases x 6 wide per edge at 3.35 TB/s
    assert cost.conv_bound_s(config, s) == pytest.approx(
        3 * 4 * e * BASES * h / 3.35e12, rel=1e-15)
    assert cost.model_flops(config, s) == 2 * 2 * e * BASES * h + \
        4 * e * BASES * h
    elements = BASES * n * h + n * h + h + BASES * h * c + h * c + c + \
        2 * 267 * BASES
    assert cost.trainable_elements(config, s) == elements
    assert cost.adam_bound_s(config, s) == 28 * elements / 3.35e12
