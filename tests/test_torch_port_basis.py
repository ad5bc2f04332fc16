"""The featureless basis model (``models/heads.py`` ``FeaturelessModel``,
``ops/basis_kernels.py``'s plain route on the CPU) against the benchmark's
plain float64 reference (``rgcn_bench/reference/trunk_basis.py`` behind
``head_featureless.py``: plain torch, no kernel of the port, no JAX), at
the basis cell's widths over a tiny AM-shaped graph, from the seeded
weights both draw alike:

- the logits, the loss and every leaf's gradient of one forward;
- a 3-epoch ``Trainer.fit`` against ``rgcn.fit``'s losses and validation
  metrics, and the harness's comparison of the set-up fit's two steps;
- the reference's blocked, recomputed layer 1 against the unblocked
  formula (``W_r`` materialised), values and gradients;
- the cost counts at AM's size, pinned to the figures worked out by hand;
- the step's marks: ``basis.out`` and ``basis.grad`` in order, the basis
  list of the replayed epochs, and the dense trunk's ten names as before.

Tolerances: the port computes in float32 and the reference in float64, so
values are held to ``REL`` of the largest reference magnitude: a float32
sum of a few dozen 40-term products rounds at about 1e-7 of its size. The
losses and the compared numbers are held to 1e-6, as
``rgcn_bench/tests/test_rgcnbench_reference.py`` holds the dense cells'.
"""

import math

import pytest
import torch

from rgcn_bench import compare, cost, harness, inputs, spec, system
from rgcn_bench.reference import rgcn, trunk_basis
from rgcn_bench.tests.tiny import tiny_cell
from scaling_rgcn_training_tpu_torch.ops import basis_kernels, cuda_build
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    RGCNLayer, build_rel_edges, rgcn_conv)
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.utils import tracing
from tests.test_torch_port_step_graph import _setup, graph_route  # noqa: F401
from tests.test_torch_port_step_marks import SLOTS

CELL = "am_rgcn_paper_basis"
SEED = 2**33 + 11
# float32 against float64 (see the module)
REL = 1e-5
LEAVES = ["rgcn1.bases", "rgcn1.comp", "rgcn1.root", "rgcn1.bias",
          "rgcn2.weight", "rgcn2.root", "rgcn2.bias", "rgcn2.comp"]
BASIS_SLOTS = ["step.start", "trunk.in", "basis.out", "trunk.out",
               "trunk.in", "basis.out", "trunk.out", "loss", "basis.grad",
               "trunk.grad", "backward", "optimizer", "step.end"]


@pytest.fixture(scope="module")
def tiny():
    """The tiny cell, its inputs and the reference's edges."""
    cell = tiny_cell(CELL)
    inp = inputs.make(cell, SEED)
    edges = rgcn.build_edges(*inp.triples, cell.config["num_entities"],
                             "cpu")
    return cell, inp, edges


def _program(cell, inp):
    return system.build(cell.config, inp,
                        inputs.params(cell.config, inp, "cpu"), "cpu")


def _close(got, want):
    scale = float(want.abs().max())
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= REL * max(scale, 1e-30)


def test_forward_and_gradients_match_reference(tiny):
    cell, inp, edges = tiny
    config = cell.config
    program = _program(cell, inp)
    model = program.model
    assert [k for k, _ in model.named_parameters()] == LEAVES
    rows = torch.as_tensor(inp.labels["x_train"])
    classes = torch.as_tensor(inp.labels["y_train"])
    logits = model(program.graph.edges)
    loss = rgcn.cross_entropy(logits[rows], classes)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    params = {k: v.double().requires_grad_() for k, v in
              inputs.params(config, inp, "cpu").items()}
    ref = trunk_basis.forward(None, params, edges, "float64")
    ref_loss = rgcn.cross_entropy(ref[rows], classes)
    ref_grads = torch.autograd.grad(ref_loss, [params[k] for k in LEAVES])
    _close(logits.detach(), ref.detach())
    assert math.isclose(float(loss.detach()), float(ref_loss.detach()),
                        rel_tol=1e-6)
    for name, g, want in zip(LEAVES, grads, ref_grads):
        assert float(want.abs().max()) > 0, name
        _close(g, want)


def test_fit_and_comparison_match_reference(tiny):
    cell, inp, edges = tiny
    config = cell.config
    params0 = inputs.params(config, inp, "cpu")
    _, accs, losses, f1_w, f1_m = _program(cell, inp).fit(3, None)
    ref = rgcn.fit(config, edges, inp.labels, params0, 3)
    assert losses == pytest.approx(ref.losses, rel=1e-6)
    # the port's accuracy and F1 are float32 (train/metrics.py)
    for got, want in zip(zip(accs, f1_w, f1_m), ref.val):
        assert list(got) == pytest.approx(list(want), rel=1e-6)
    # the harness's set-up fit and its eight numbers
    start, replay, state = system.first_steps(_program(cell, inp), config,
                                              harness.SETUP_EPOCHS)
    fit = lambda at: rgcn.fit(config, edges, inp.labels, params0, 1,
                              state=at)
    values = compare.both(config, (start, fit(None)), (replay, fit(state)),
                          params0, state, inp.labels["y_val"])
    assert state.step == 3 and set(values) == set(compare.NUMBERS)
    for key in ("loss", "grad", "change", "replay_loss", "replay_grad",
                "replay_change"):
        assert values[key] < 1e-6, (key, values[key])


def _unblocked_layer1(params, edges):
    """``W = comp @ bases`` materialised ``[R, N, h]``; each edge's
    ``norm_e W[rel_e, src_e]`` onto its dst."""
    bases, comp = params["rgcn1.bases"], params["rgcn1.comp"]
    w = torch.einsum("rb,nbh->rnh", comp, bases)
    out = params["rgcn1.root"] + params["rgcn1.bias"]
    for slot, lo, hi in edges.slots:
        msg = w[slot].index_select(0, edges.src[lo:hi]) * \
            edges.norm[lo:hi, None].double()
        out = out.index_add(0, edges.dst[lo:hi], msg)
    return out


@pytest.mark.parametrize("block", [97, 1000, trunk_basis.BLOCK])
def test_blocked_reference_is_the_formula(tiny, block):
    cell, inp, edges = tiny
    params = {k: v.double().requires_grad_() for k, v in
              inputs.params(cell.config, inp, "cpu").items()}
    g = torch.randn(cell.config["num_entities"], cell.config["hidden"],
                    generator=torch.Generator().manual_seed(block),
                    dtype=torch.float64)
    leaves = [params[f"rgcn1.{k}"] for k in ("bases", "comp", "root",
                                             "bias")]
    got = trunk_basis.layer1(params, edges, "float64", block=block)
    want = _unblocked_layer1(params, edges)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-15)
    for a, b in zip(torch.autograd.grad(got, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-15)


AM = {"nodes": 1_666_764, "edges": 11_976_642, "slots": 267,
      "chunks": 11_824}


def test_costs_at_am_size():
    config = spec.load_cell(CELL).config
    calls = trunk_basis.basis_calls(config, AM)
    assert [c[0] for c in calls] == [2_877_255_384, 2_877_255_384,
                                     5_544_120_504]
    bound_s = sum(max(b / cost.PEAKS["hbm_bytes_per_s"], ops / cost.PEAKS[u])
                  for b, ops, u in calls)
    assert bound_s * 1e3 == pytest.approx(3.3727, abs=1e-4)
    assert cost.model_flops(config, AM) == 50_331_451_680
    assert sum(trunk_basis.param_elements(config, AM).values()) == \
        683_399_131
    assert cost.trainable_elements(config, AM) == 683_399_131
    assert trunk_basis.conv_calls(config, AM) == [
        cost.span_forward_cost(AM, 10, 11), cost.span_forward_cost(AM, 10, 11),
        cost.span_backward_cost(AM, 10, 11)]


def test_plain_route_on_the_cpu_and_its_limits(tiny):
    cell, inp, _ = tiny
    program = _program(cell, inp)
    tracing.reset()
    before = dict(cuda_build.LAUNCHES)
    with torch.no_grad():
        program.model(program.graph.edges)
    assert cuda_build.LAUNCHES == before
    assert tracing.counters().get("basis.plain") == 1
    assert "basis.fused" not in tracing.counters()
    layer = program.model.rgcn1
    assert "not on a card" in basis_kernels.refusal(
        layer.bases, layer.comp, layer.root, layer.bias,
        program.graph.edges.span)
    dense = RGCNLayer(torch.zeros(13, 4, 3), torch.zeros(4, 3),
                      torch.zeros(3))
    with pytest.raises(ValueError):
        rgcn_conv(None, program.graph.edges, dense)
    with pytest.raises(ValueError):
        rgcn_conv(None, program.graph.edges, layer, aggr="attention")
    tracing.reset()


def test_init_featureless_model_draws_pyg_leaves():
    """``init_featureless_model``: the leaves' shapes (rgcn1's bases
    node-major, rgcn2's PyG's ``[B, in, out]``) and glorot bounds, zero
    biases, and a forward to ``[N, C]`` logits on the CPU's plain route."""
    from scaling_rgcn_training_tpu_torch.models.heads import (
        init_featureless_model)

    n, slots, h, c, b = 50, 7, 10, 11, 40
    model = init_featureless_model(torch.Generator().manual_seed(0), slots,
                                   h, c, n, num_bases=b)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert shapes == {"rgcn1.bases": (n, b, h), "rgcn1.comp": (slots, b),
                      "rgcn1.root": (n, h), "rgcn1.bias": (h,),
                      "rgcn2.weight": (b, h, c), "rgcn2.comp": (slots, b),
                      "rgcn2.root": (h, c), "rgcn2.bias": (c,)}
    bases = model.rgcn1.bases.detach()
    assert float(bases.abs().max()) <= math.sqrt(6 / (n + h))
    assert float(model.rgcn2.weight.detach().abs().max()) <= \
        math.sqrt(6 / (h + c))
    assert float(model.rgcn2.comp.detach().abs().max()) <= \
        math.sqrt(6 / (slots + b))
    assert not model.rgcn1.bias.any() and not model.rgcn2.bias.any()
    rng = torch.Generator().manual_seed(1)
    src, dst = (torch.randint(0, n, (300,), generator=rng).numpy()
                for _ in range(2))
    typ = torch.randint(0, slots, (300,), generator=rng).numpy()
    edges = build_rel_edges(src.astype("int32"), dst.astype("int32"),
                            typ.astype("int32"), n, slots)
    assert model(edges).shape == (n, c)


def test_plan_positions_invert_the_orders():
    src = torch.tensor([3, 0, 0, 2, 3, 1], dtype=torch.int32).numpy()
    dst = torch.tensor([0, 0, 3, 1, 1, 3], dtype=torch.int32).numpy()
    typ = torch.tensor([1, 0, 1, 1, 0, 2], dtype=torch.int32).numpy()
    edges = build_rel_edges(src, dst, typ, 4, 3)
    span = edges.span
    perm = edges.basis_perm
    # the q-th dst-sorted edge is the perm[q]-th src-sorted edge
    assert torch.equal(span.bwd_pos[perm.long()], span.fwd_pos)
    assert torch.equal(span.fwd_rel, span.bwd_rel[perm.long()])


def test_step_marks_of_a_featureless_fit(graph_route):  # noqa: F811
    """A 6-epoch fit on the stand-in graph route, featureless: the
    basis marks in order, a basis interval a replay inside its conv, the
    layers adding up to the step; then a dense fit: its ten marks."""
    tracing.reset()
    cell = tiny_cell(CELL)
    inp = inputs.make(cell, SEED)
    try:
        program = _program(cell, inp)
        program.fit(6, None)
        fit = tracing.fits()[-1]
        assert fit["slots"] == BASIS_SLOTS
        replays = [e for e in tracing.epochs(fit["fit"])
                   if e["kind"] == "replay"]
        assert len(replays) == 4
        layers = tracing.replay_layers()
        assert len(layers["basis"]) == 4
        for e, basis in zip(replays, layers["basis"]):
            assert e["basis_ns"] == basis
            assert 0 < basis < e["conv_ns"]
            assert e["conv_ns"] + e["head_ns"] + e["adam_ns"] == \
                e["end_ns"] - e["start_ns"]
        # two forwards in each of 6 epochs and in the capture
        assert tracing.counters()["basis.plain"] == 14
        trainer, model, graph = _setup("fused", "summation", 5)
        loss_fn, act = tlosses.get_loss("SYNTH", sum_model=False)
        trainer.fit(model, graph, loss_fn, act, sum_graph=False,
                    verbose=False)
        assert tracing.fits()[-1]["slots"] == SLOTS
        assert "basis_ns" not in tracing.epochs(tracing.fits()[-1]["fit"])[0]
        assert len(tracing.replay_layers()["basis"]) == 4
    finally:
        tracing.reset()


def test_basis_cell_resolves_every_file():
    """The cell's entry: one chip, the configuration under ``paths`` with
    nothing reduced, its traffic, limits for the eight numbers, a reader
    for each of its per-layer metrics and the basis kernel table."""
    bench = spec.load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}[CELL]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    assert work["chips"] == 1 and conf["reduced"] == []
    assert conf["file"].startswith("rgcn_bench/configs/")
    cell = spec.load_cell(CELL)
    assert cell.config["name"] == conf["name"]
    assert (cell.config["head"], cell.config["trunk"]) == ("featureless",
                                                           "basis")
    assert spec.traffic_generator(cell.traffic).triples
    assert set(cell.limits) == set(compare.NUMBERS)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert "basis_msg_kernel" in spec.kernel_layers()["basis"]


@pytest.mark.parametrize("name,layer", [
    ("basis_ms", "basis"), ("basis_roofline", "basis"),
    ("basis_span_ms", "basis"), ("basis_step_mfu", "step dispatch"),
    ("conv_roofline", "conv"), ("adam_roofline", "optimizer")])
def test_basis_metrics_in_the_benchmark(name, layer, monkeypatch):
    """Each new metric has its reader and lists only the basis cell; the
    accepted rooflines list it last; each reads nothing, raising nothing,
    without a trace or the recorder's basis list (a program without the
    basis layer)."""
    bench = spec.load_benchmark()
    assert spec.check_names(bench) == []
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    assert entry["workloads"][-1] == CELL and entry["layer"] == layer
    if name.startswith("basis"):
        assert entry["workloads"] == [CELL]
    cell = spec.load_cell(CELL)
    record = harness.RunRecord(cell.config, AM, 1.0, [], None,
                               spec.kernel_layers())
    monkeypatch.setattr(tracing, "replay_layers",
                        lambda fit=None: {"conv": [], "head": [], "adam": [],
                                          "between": []})
    assert spec.metric_reader(name).read(record) is None


def test_lean_calibration_reads_what_calibrate_reads():
    """``rgcn_bench/calibrate_lean.py`` (each step compared as its fits
    return) gives ``calibrate.py``'s readings, numbers and details, for
    the program, the control and each fault."""
    from rgcn_bench import calibrate, calibrate_lean

    cell = tiny_cell(CELL)
    want = calibrate.readings(cell, 5, True, "cpu")
    got = calibrate_lean.readings(cell, 5, True, "cpu")
    assert [k for k, _ in got] == [k for k, _ in want] == \
        ["program", "tf32", "half_batch", "late_eval"]
    for (_, a), (_, b) in zip(got, want):
        assert a == b
